"""Command-line interface: ``matcher-service`` and ``version``.

    python -m maxmq_tpu_torch matcher-service --socket PATH [--device cuda|cpu]

serves topic matches on a unix socket; a JAX-package broker started with
``matcher = "service"`` (and ``matcher_socket = PATH``) attaches
to it unchanged. The service runs on the card unless ``--device cpu`` is
given; with no CUDA device it refuses to start.
"""

from __future__ import annotations

import argparse
import asyncio
import sys

from . import __version__


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="maxmq_tpu_torch",
        description="maxmq-tpu-torch: the maxmq matcher service on CUDA")
    sub = parser.add_subparsers(dest="command")
    svc = sub.add_parser(
        "matcher-service",
        help="run the card-owning matcher service: brokers started with "
             "matcher = \"service\" connect to its socket")
    svc.add_argument("--socket", "-s", default="/tmp/maxmq-matcher.sock",
                     help="unix socket path to serve on")
    svc.add_argument("--device", default=None, choices=("cuda", "cpu"),
                     help="where the tables live and the kernel runs "
                          "(default: cuda; fails without a CUDA device)")
    sub.add_parser("version", help="print version information")
    return parser


def cmd_version() -> int:
    import torch

    from .utils.build import get_info

    print(f"{get_info().long_version()} (maxmq-tpu-torch {__version__}, "
          f"torch {torch.__version__}, cuda {torch.version.cuda})")
    return 0


def cmd_matcher_service(args: argparse.Namespace) -> int:
    from .matching.service import MatcherService
    from .matching.sig import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        print(f"matcher-service: {exc}", file=sys.stderr)
        return 2

    async def run() -> None:
        svc = MatcherService(args.socket, device=device)
        await svc.start()
        print(f"matcher service on {args.socket} ({device})",
              file=sys.stderr, flush=True)
        try:
            await asyncio.Event().wait()
        finally:
            await svc.close()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = make_parser()
    args = parser.parse_args(argv)
    if args.command == "version":
        return cmd_version()
    if args.command == "matcher-service":
        return cmd_matcher_service(args)
    parser.print_help()
    return 0


if __name__ == "__main__":
    sys.exit(main())
