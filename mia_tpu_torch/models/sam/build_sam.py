"""SAM registry (counterpart of ``sam_model_registry`` in
``mia_tpu/models/sam/build_sam.py``, plain ``Sam`` only).

``sam_model_registry[name](image_size, num_classes) -> (model, embed_size)``
builds the module with PyTorch's initialisers, on the CPU unless
``device`` is given. Loading a reference checkpoint (the ``load_from``
surgery of ``import_torch_sam_encoder``) is not ported yet.
"""

from __future__ import annotations

from .sam import Sam

_VIT_SPECS = {
    "vit_h": dict(embed_dim=1280, depth=32, num_heads=16, global_idx=(7, 15, 23, 31)),
    "vit_l": dict(embed_dim=1024, depth=24, num_heads=16, global_idx=(5, 11, 17, 23)),
    "vit_b": dict(embed_dim=768, depth=12, num_heads=12, global_idx=(2, 5, 8, 11)),
}


def _build_plain(spec_name: str):
    spec = _VIT_SPECS[spec_name]

    def build(image_size, num_classes, checkpoint=None, device=None):
        if checkpoint is not None:
            raise NotImplementedError("loading a SAM checkpoint is not ported yet")
        model = Sam(
            img_size=image_size,
            num_classes=num_classes,
            encoder_embed_dim=spec["embed_dim"],
            encoder_depth=spec["depth"],
            encoder_num_heads=spec["num_heads"],
            encoder_global_attn_indexes=spec["global_idx"],
        )
        return model.to(device) if device is not None else model, image_size // 16

    return build


sam_model_registry = {
    "default": _build_plain("vit_h"),
    "vit_h": _build_plain("vit_h"),
    "vit_l": _build_plain("vit_l"),
    "vit_b": _build_plain("vit_b"),
}
