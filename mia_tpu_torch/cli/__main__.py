"""``python -m mia_tpu_torch.cli`` argparse subcommand framework
(counterpart of ``mia_tpu/cli/__main__.py``)."""

from __future__ import annotations

from argparse import ArgumentParser
from pathlib import Path

from .commands import available_commands


def setup_parser() -> ArgumentParser:
    work_dir = Path.cwd()
    parser = ArgumentParser(prog="mia_tpu_torch.cli")
    parser.add_argument("-l", "--log-file", dest="log_file_str", type=str)
    parser.add_argument("-d", "--debug", dest="do_debug", action="store_true")
    parser.add_argument("-q", "--quiet", dest="do_verbose", action="store_false")

    subparsers = parser.add_subparsers()
    for command_cls in available_commands:
        command_cls(work_dir).setup_parser(subparsers)
    return parser


def main(argv=None):
    parser = setup_parser()
    args = vars(parser.parse_args(argv))
    func = args.pop("func", None)
    if func is None:
        parser.print_help()
        return

    from ..utils.logging import setup_logger

    setup_logger(
        "MIA.cli",
        log_path=args.pop("log_file_str", None),
        verbose=bool(args.pop("do_verbose", True)),
    )
    args.pop("do_debug", None)
    func(**args)


if __name__ == "__main__":
    main()
