from .label_studio import decode_rle, encode_rle, mask2annotation, mask2rle, remove_noise_diagonal

__all__ = ["decode_rle", "encode_rle", "mask2annotation", "mask2rle", "remove_noise_diagonal"]
