"""Command-line interface: ``start``, ``matcher-service`` and ``version``.

    python -m maxmq_tpu_torch start [-c maxmq.conf] [--device cuda|cpu]

boots the broker from its config (TOML file, then ``MAXMQ_*`` env) and
runs it until SIGINT/SIGTERM, as the JAX package's ``maxmq start`` does.
With ``workers > 1`` it runs the worker pool: this process owns the
matcher sidecar (on ``--device``) and spawns the workers as ``start``
processes with the same ``--device``; a worker logs and installs its
event loop as the box's config says (``MAXMQ_POOL_CONF``);

    python -m maxmq_tpu_torch matcher-service --socket PATH [--device cuda|cpu]

serves topic matches on a unix socket; a broker of either package started
with ``matcher = "service"`` (and ``matcher_socket = PATH``) attaches to it
unchanged. Both run on the card unless ``--device cpu`` is given; with no
CUDA device and no ``--device cpu`` they refuse to start.

Parity surface: cmd/maxmq/main.go + internal/cli in the reference — a root
command with ``start`` (start.go:50-80) and ``version`` (version.go:22-33).
"""

from __future__ import annotations

import argparse
import asyncio
import os
import sys

from . import __version__


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="maxmq_tpu_torch",
        description="maxmq-tpu-torch: the maxmq MQTT broker and its matcher "
                    "service on PyTorch and CUDA")
    sub = parser.add_subparsers(dest="command")

    start = sub.add_parser("start", help="start the broker server")
    start.add_argument("--config", "-c", default=None,
                       help="path to maxmq.conf (TOML); default: search "
                            "., /etc/maxmq, /etc")
    start.add_argument("--profile", action="store_true",
                       help="write cpu.prof and heap.prof on shutdown")
    start.add_argument("--no-banner", action="store_true")
    start.add_argument("--device", default=None, choices=("cuda", "cpu"),
                       help="where the matcher engine (a worker pool's "
                            "sidecar) and the content plane's torch "
                            "evaluator run (default: cuda; fails without "
                            "a CUDA device)")

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


def _device(command: str, requested):
    """The device a command runs on, or None after saying on stderr why
    there is none (no CUDA and no ``--device cpu``)."""
    from .matching.sig import resolve_device

    try:
        return resolve_device(requested)
    except RuntimeError as exc:
        print(f"{command}: {exc}", file=sys.stderr)
        return None


def cmd_start(args: argparse.Namespace) -> int:
    from .bootstrap import (BANNER, install_event_loop,
                            new_logger_from_config, pool_worker_config,
                            run_server)
    from .utils.config import load_config

    conf = load_config(path=args.config)
    if os.environ.get("MAXMQ_WORKER_ID") is not None:
        # a pool worker: the parent resolved the device and owns the card
        # (its matcher sidecar); probing CUDA here would open the card in
        # every worker
        conf = pool_worker_config(conf)
        device = args.device
    else:
        device = _device("start", args.device)
        if device is None:
            return 2
        device = device.type
    if args.profile:
        conf.profile = True
    logger = new_logger_from_config(conf)
    if not args.no_banner:
        print(BANNER, file=sys.stderr)
    # ADR 023 satellite: the loop policy must land before asyncio.run
    loop = install_event_loop(conf.broker_event_loop, logger)
    logger.with_prefix("bootstrap").info("event loop installed", loop=loop)
    try:
        asyncio.run(run_server(conf, logger, device=device))
    except KeyboardInterrupt:
        pass
    except Exception as exc:
        logger.with_prefix("bootstrap").fatal("server failed",
                                              error=str(exc))
        return 1
    return 0


def cmd_matcher_service(args: argparse.Namespace) -> int:
    from .matching.service import MatcherService

    device = _device("matcher-service", args.device)
    if device is None:
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
    if args.command == "start":
        return cmd_start(args)
    if args.command == "matcher-service":
        return cmd_matcher_service(args)
    parser.print_help()
    return 0


if __name__ == "__main__":
    sys.exit(main())
