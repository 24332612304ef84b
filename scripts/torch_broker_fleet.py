#!/usr/bin/env python3
"""The broker engine's fan-out to a connected fleet on the card: phase 12
of ``chip_smoke.py`` at ``iot_1m_share`` with its fleet rung.

    python3 scripts/torch_broker_fleet.py

Needs one NVIDIA card. Boots phase 12's two port brokers (``build_matcher``
"sig" on the card, and the CPU trie) on the 1,000,000-subscription corpus,
runs the TCP subscribers' bypass-off and bypass-on runs at 256 publishes,
then the fleet rung: every corpus client that 4,096 fresh publishes reach
(61,704 of them) made a live in-process session of both brokers, each
acknowledging its QoS 1/2 deliveries after each burst's fence, and the
publishes through the trie broker, then the card broker. Each session's
bytes and every match answer must equal the trie broker's; the card run's
hedges, trips, spans, loop lag and full collections are printed on its
``[broker] iot_1m_share fleet`` line, and the phase fails on any answer
not from the engine.
"""

from __future__ import annotations

import asyncio
import faulthandler
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402

WATCHDOG_S = 1_150


def main() -> int:
    from maxmq_tpu_torch import kernels, native

    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    t0 = time.perf_counter()
    kernels.build_all()
    native.build_all()
    chip_smoke.log(f"[build] {time.perf_counter() - t0:.1f} s")
    chip_smoke.log(f"[card] {chip_smoke.card_line()}")
    s = chip_smoke.Smoke("cuda")
    s.sizes = {**s.sizes, "broker": {**s.sizes["broker"],
                                     "iot_1m_share": 256,
                                     "bypass_on": ("iot_1m_share",),
                                     "fleet": {"iot_1m_share": 4_096}}}
    t0 = time.perf_counter()
    asyncio.run(s.broker_phase("iot_1m_share"))
    chip_smoke.log(f"[done] {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
