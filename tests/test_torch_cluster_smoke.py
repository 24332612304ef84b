"""``chip_smoke.py`` phase 16 (the cluster federation) rehearsed on the CPU
at a small size: six ``python -m maxmq_tpu_torch start`` children in two
federations over a line A - B - C, the "card" federation's ``sig`` nodes on
``--device cpu`` here; and the phase's helpers."""

import asyncio
import os

import pytest

import chip_smoke
from maxmq_tpu.cluster.routes import minimal_cover

FED_CPU_SIZES = {"subs": {"mixed_100k": 3_000},
                 "federation": {"corpus": "mixed_100k", "clients": 16,
                                "publishes": 256, "takeover_publishes": 64,
                                "rung_publishes": 64, "rung_burst": 8,
                                "takeovers": 4,
                                "burst": 64, "max_batch": 4_096,
                                "boot_s": 150.0, "stop_s": 30.0,
                                "converge_s": 60.0, "telemetry_s": 15.0,
                                "in_process": {"subs": 3_000, "clients": 16,
                                               "publishes": 128, "burst": 64,
                                               "takeovers": 4},
                                "device_share": 0.5}}


async def _beside_the_boots() -> None:
    """What the whole run does while the early nodes boot (phase 15's
    crash rung): this loop busy, then idle, while the boots' thread waits
    on its own."""
    for _ in range(20):
        sum(range(200_000))
        await asyncio.sleep(0.05)


@pytest.mark.timeout(280)
@pytest.mark.parametrize("start", ["alone", "early"])
def test_federation_phase_rehearses_on_cpu(start):
    smoke = chip_smoke.Smoke("cpu", sizes=FED_CPU_SIZES)
    if start == "early":
        # as the whole run starts them: in phase 15's crash rung, booting
        # in a thread while that phase goes on
        smoke.fed_start_early()
        asyncio.run(_beside_the_boots())
        assert smoke.fed_pending is not None
    out = asyncio.run(smoke.federation())
    assert smoke.fed_pending is None
    assert out["boot_overlapped"] is (start == "early")
    assert out["routes_expected"] == {"A": 1, "B": 2, "C": 1}   # '#' probes
    for run in (out["traffic"], out["rung"]["traffic"]):
        assert run["deliveries_compared"] > 100
        assert run["nodes"]["B"]["forwards"]["forwards_sent"] > 0
        assert run["nodes"]["A"]["forwards"]["forwards_delivered"] > 0
    assert set(out["boot"]) == {f"{f}-{n}" for f in ("trie", "card")
                                for n in "ABC"}
    assert set(out["rung"]["boot"]) == {"trie-B", "card-B"}
    assert all(len(v) == 3 for v in out["telemetry"].values())
    for node, counts in out["stores"].items():
        assert counts["clients"] > 900 and counts["inflight"] > 0, node
        # every node's ledger journal holds every session of the line
        assert counts["cluster_sessions"] >= out["ledger_sessions"], node
        assert counts["cluster_inflight"] > 0, node
    # both takeover rungs: B's sessions taken over live at C and from the
    # dead owner at A, equal between the federations, none degraded
    assert out["takeovers"] == {"live": 4, "dead_owner": 4}
    assert out["takeover"]["resent_compared"] > 0
    assert out["rung"]["takeover"]["resent_compared"] > 0
    for run in (out["converge"], out["rung"]["converge"]):
        assert run["ledger_s"] >= 0 and run["converge_s"] >= 0
    assert sum(c["takeovers"] for c in out["sessions"].values()) == 8
    assert not any(c["takeovers_degraded"] or c["digest_mismatches"]
                   for c in out["sessions"].values())
    # the sampled latencies reached /metrics, and the in-process line's
    # engines answered every node's topics with the bypass off
    lat = out["traffic"]["nodes"]["A"]["latency_ms"]["card"]
    assert lat["match_device"][0] is not None and lat["cluster_e2e"]
    assert out["in_process"]["deliveries_compared"] > 100
    for node, counts in out["in_process"]["nodes"].items():
        assert counts["device_share"] > 0.5, (node, counts)
    # the in-process line's live takeover: the new owner's engine served
    # the taken-over sessions' publishes
    tk = out["in_process"]["takeover"]
    assert tk["sessions"]["C"]["takeovers"] == 4
    assert tk["matchers"]["C"]["batches"] > 0
    assert out["in_process"]["taken_over_frames"] > 0


@pytest.mark.timeout(120)
def test_fed_abort_stops_early_nodes():
    """Nodes started for phase 16 that the phase never takes over (an
    earlier failure): every node killed, the directory removed."""
    smoke = chip_smoke.Smoke("cpu", sizes=FED_CPU_SIZES)
    smoke.fed_start_early()
    st, thread, box = smoke.fed_pending
    asyncio.run(asyncio.sleep(1.0))
    smoke.fed_abort()
    assert smoke.fed_pending is None and not thread.is_alive()
    assert all(b.proc.poll() is not None for b in st["brokers"].values())
    assert not os.path.exists(st["work"]) and "error" in box
    smoke.fed_abort()       # nothing pending: a no-op


def test_fed_plan_spreads_the_subscribers_and_probes():
    kit = chip_smoke.port_kit()
    plan = [(f"tcp-{k}", 4, 0, False, []) for k in range(7)]
    plan.append(("tcp-probe", 4, 0, False, [kit.Subscription(filter="#")]))
    fed = chip_smoke.fed_plan(kit, plan)
    assert [(n, c) for n, c, *_r in fed[:7]] == [
        ("A", "tcp-0"), ("B", "tcp-1"), ("C", "tcp-2"), ("A", "tcp-3"),
        ("B", "tcp-4"), ("C", "tcp-5"), ("A", "tcp-6")]
    assert [(n, c, [s.filter for s in subs]) for n, c, _v, _a, _o, subs
            in fed[7:]] == [(n, f"tcp-probe-{n}", ["#"]) for n in "ABC"]
    assert len(chip_smoke.fed_plan(kit, plan, probes=False)) == 7
    assert "cluster_session" not in chip_smoke.fed_config(
        "B", {"A": 1, "B": 2, "C": 3})
    assert 'cluster_peers = "A@127.0.0.1:1,C@127.0.0.1:3"' in \
        chip_smoke.fed_config("B", {"A": 1, "B": 2, "C": 3})


@pytest.mark.parametrize("seed", [3, 4])
def test_fed_routes_equal_the_reference_cover(seed):
    """The routes each node holds once the line converges, computed with
    the JAX package's ``minimal_cover`` (split horizon by hand)."""
    filters, _gen = chip_smoke.build_corpus(240, seed=seed)
    local = {n: set(filters[i::3]) for i, n in enumerate("ABC")}
    a_to_b = minimal_cover(local["A"])
    c_to_b = minimal_cover(local["C"])
    b_to_a = minimal_cover(local["B"] | c_to_b)
    b_to_c = minimal_cover(local["B"] | a_to_b)
    assert chip_smoke.fed_routes(local) == {
        "A": len(b_to_a), "B": len(a_to_b) + len(c_to_b), "C": len(b_to_c)}
    assert chip_smoke.fed_local_filters(
        [("c", 5, [chip_smoke.port_kit().Subscription(filter=f) for f in
                   ("$share/g/a/b", "$SYS/x", "a/b", "c/#")])]) == \
        {"a/b", "c/#"}


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_without_trace_drops_only_the_trace_property(seed):
    """A v5 PUBLISH with an ``mq-trace`` user property among the others,
    stripped, equals the same publish encoded without it; one without it
    comes back as it was; and a stored record loses the pair alike."""
    import json

    import numpy as np

    kit = chip_smoke.port_kit()
    rng = np.random.default_rng(seed)
    for i in range(64):
        qos = int(rng.integers(0, 3))

        def publish(trace: bool):
            pk = kit.Packet(fixed=kit.FixedHeader(type=kit.PT.PUBLISH,
                                                  qos=qos),
                            protocol_version=5, topic=f"a/{i}/b" * (1 + i % 40),
                            payload=bytes(int(rng.integers(0, 300))))
            if qos:
                pk.packet_id = 1 + i
            pr = pk.properties
            users = [(f"k{j}", f"v{j}" * (1 + j)) for j in range(i % 3)]
            if trace:
                users.insert(i % (len(users) + 1), ("mq-trace", f"A:{i}"))
            pr.user_properties = users
            pr.subscription_ids = [1 + i * 300] if i % 2 else []
            pr.correlation_data = b"c" * (i % 5)
            pr.message_expiry = 60 if i % 4 == 0 else None
            pr.topic_alias = 3 if i % 5 == 0 else None
            return pk.encode()

        state = rng.bit_generator.state
        traced = publish(True)
        rng.bit_generator.state = state
        plain = publish(False)
        assert traced != plain
        assert chip_smoke.without_trace(traced) == plain
        assert chip_smoke.without_trace(plain) is plain
    rec = {"properties_json": json.dumps(
        {"content_type": "x", "user_properties": [["mq-trace", "A:1"],
                                                  ["k", "v"]]})}
    assert chip_smoke.drop_trace(rec)["properties_json"] == {
        "content_type": "x", "user_properties": [["k", "v"]]}
    rec = {"properties_json": json.dumps(
        {"user_properties": [["mq-trace", "A:1"]]})}
    assert chip_smoke.drop_trace(rec)["properties_json"] == {}
