"""``demo_serve_torch``: the interactive AL demo (``serve.py``)."""
