from .common import draw_mask, get_path
from .logging import add_file_sink, remove_sink, setup_logger

__all__ = ["add_file_sink", "draw_mask", "get_path", "remove_sink", "setup_logger"]
