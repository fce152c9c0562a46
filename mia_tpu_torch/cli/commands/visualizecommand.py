"""``visualize`` subcommand (counterpart of
``mia_tpu/cli/commands/visualizecommand.py``): open an image, optionally
overlay a mask file, show it or save it."""

from __future__ import annotations

import logging
from argparse import ArgumentParser
from pathlib import Path

from .basecommand import BaseCommand

logger = logging.getLogger("MIA.cli")


class VisualizeCommand(BaseCommand):
    def setup_parser(self, subparser) -> ArgumentParser:
        if subparser is None:
            parser = ArgumentParser()
        else:
            parser = subparser.add_parser("visualize", help="Visualize data")
        parser.add_argument(
            "-f", "--image-file", dest="image_file_str", type=str, help="Path to file"
        )
        parser.add_argument(
            "-m", "--mask-file", dest="mask_file_str", type=str, default=None,
            help="Optional mask PNG to overlay",
        )
        parser.add_argument(
            "-o", "--output", dest="output_str", type=str, default=None,
            help="Save instead of showing",
        )
        parser.set_defaults(func=self)
        return parser

    def __call__(self, image_file_str: str, mask_file_str=None, output_str=None, **kw):
        from PIL import Image

        image_file = Path(image_file_str)
        logger.debug(f"Read and show {image_file.resolve()}")
        image = Image.open(image_file)
        if mask_file_str:
            import numpy as np

            from ...utils.common import draw_mask

            mask = np.array(Image.open(mask_file_str))
            image = Image.fromarray(draw_mask(np.array(image.convert("RGB")), mask))
        if output_str:
            image.save(output_str)
        else:
            image.show()
