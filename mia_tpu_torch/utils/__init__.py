from .common import draw_mask, get_path
from .images import read_nrrd, write_nrrd
from .logging import add_file_sink, remove_sink, setup_logger

__all__ = ["add_file_sink", "draw_mask", "get_path", "read_nrrd", "remove_sink", "setup_logger",
           "write_nrrd"]
