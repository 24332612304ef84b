"""``chip_smoke.py`` phase 17 (the worker pool) rehearsed on the CPU at a
small size: two ``python -m maxmq_tpu_torch start`` pools of two workers
over copies of one restored store, the "card" pool's ``sig`` sidecar on
``--device cpu`` here; and the phase's helpers."""

import asyncio
import os

import pytest

import chip_smoke

POOL_CPU_SIZES = {"subs": {"mixed_100k": 3_000},
                  "pool": {"corpus": "mixed_100k", "clients": 16,
                           "publishes": 256, "burst": 64, "max_batch": 4_096,
                           "boot_s": 150.0, "stop_s": 30.0,
                           "converge_s": 60.0}}


async def _beside_the_boot(smoke) -> None:
    """What the whole run does while the early pools boot (phase 16's
    store comparison and its line in this process): this loop busy, then
    idle, while the boot's thread waits on its own."""
    for _ in range(20):
        sum(range(200_000))
        await asyncio.sleep(0.05)
    assert smoke.pool_pending is not None


@pytest.mark.timeout(280)
@pytest.mark.parametrize("start", ["alone", "early"])
def test_worker_pool_phase_rehearses_on_cpu(start):
    smoke = chip_smoke.Smoke("cpu", sizes=POOL_CPU_SIZES)
    if start == "early":
        # as the whole run starts it: at phase 16's end, booting in a
        # thread while that phase goes on
        smoke.pool_start_early()
        asyncio.run(_beside_the_boot(smoke))
    out = asyncio.run(smoke.worker_pool())
    assert smoke.pool_pending is None
    assert out["boot_overlapped"] is (start == "early")
    assert out["ledger_s"] >= 0 and out["boot_wait_s"] >= 0
    assert out["deliveries_compared"] > 100
    for name in ("card", "trie"):
        boot = out["boot"][name]
        assert len(boot["pids"]) == 2 and boot["w0_restore_s"] > 0
        assert set(boot["worker_started_s"]) == {"w0", "w1"}
        assert out["cluster"][name] == {"nodes": ["w0", "w1"],
                                        "journal": ["w0"]}
        assert out[name]["commits"] > 0
    # the sidecar answered the card pool's topics: batches of both
    # workers' requests, answers equal to the trie's after the traffic
    assert out["sidecar"]["batches"] >= 1
    assert out["sidecar_answers"]["matched"] > 0
    assert out["stores"]["clients"] > 3_000 and out["stores"]["inflight"]
    assert out["stores"]["cluster_sessions"] >= out["sessions"]
    counts = out["worker_counts"]
    assert set(counts["card"]) == set(counts["trie"]) == {"w0", "w1"}
    assert all(c["launches"] == 0 for w in counts.values()
               for c in w.values())


@pytest.mark.timeout(120)
def test_pool_abort_stops_early_pools():
    """Pools started for phase 17 that the phase never takes over (an
    earlier phase failed): every process is killed and the directory
    removed."""
    smoke = chip_smoke.Smoke("cpu", sizes=POOL_CPU_SIZES)
    smoke.pool_start_early()
    st, thread, box = smoke.pool_pending
    asyncio.run(asyncio.sleep(1.0))
    pools = st["pools"]
    smoke.pool_abort()
    assert smoke.pool_pending is None and not thread.is_alive()
    assert all(p.proc.poll() is not None for p in pools)
    assert not os.path.exists(st["work"])
    # the boot's thread saw its pools die
    assert "error" in box
    smoke.pool_abort()      # nothing pending: a no-op


CHAIN_CPU_SIZES = {
    "subs": {"mixed_100k": 3_000},
    "started": {"corpus": "mixed_100k", "clients": 64, "publishes": 256,
                "burst": 64, "max_batch": 4_096, "device_share": 0.5,
                "crash_publishes": 64, "crash_after": 20, "boot_s": 150.0,
                "stop_s": 30.0},
    "federation": {"corpus": "mixed_100k", "clients": 16, "publishes": 128,
                   "takeover_publishes": 64, "rung_publishes": 64,
                   "rung_burst": 8, "takeovers": 4, "burst": 64,
                   "max_batch": 4_096, "boot_s": 150.0, "stop_s": 30.0,
                   "converge_s": 60.0, "telemetry_s": 15.0,
                   "in_process": {"subs": 3_000, "clients": 16,
                                  "publishes": 64, "burst": 64,
                                  "takeovers": 4},
                   "device_share": 0.5},
    "pool": POOL_CPU_SIZES["pool"]}


@pytest.mark.timeout(420)
def test_started_phases_chain_on_cpu():
    """Phases 15, 16 and 17 as the whole run chains them: phase 16's
    nodes boot beside phase 15's crash rung, phase 17's pools beside
    phase 16's store comparison and in-process line, each phase taking
    over what the one before started."""
    smoke = chip_smoke.Smoke("cpu", sizes=CHAIN_CPU_SIZES)
    started, federation, pool = smoke.started_phases()
    assert smoke.fed_pending is None and smoke.pool_pending is None
    assert started["crash"]["records_checked"] > 0
    assert federation["boot_overlapped"] and pool["boot_overlapped"]
    assert federation["takeovers"] == {"live": 4, "dead_owner": 4}
    assert federation["in_process"]["deliveries_compared"] > 0
    assert pool["deliveries_compared"] > 100
    for name in ("card", "trie"):
        assert set(pool["boot"][name]["worker_started_s"]) == {"w0", "w1"}


def _store(path, records) -> str:
    from maxmq_tpu_torch.hooks.storage import SQLiteStore

    store = SQLiteStore(str(path))
    for bucket, key, value in records:
        store.put(bucket, key, value)
    store.close()
    return str(path)


def test_stores_equal_leaves_out_only_the_links_records(tmp_path):
    """A bridge link's own session record left in one twin's store and
    not in the other's (which stopped first decides it: F30) is left out
    with ``links=False`` and counted; any other difference still fails,
    and with the default every record is compared."""
    user = ("clients", "cl-1", '{"client_id": "cl-1", "clean": false}')
    link = ("clients", "$maxmq-cluster/w1",
            '{"client_id": "$maxmq-cluster/w1", "clean": true}')
    link_sub = ("subscriptions", "$maxmq-cluster/w1|$cluster/#",
                '{"client_id": "$maxmq-cluster/w1", "filter": "$cluster/#"}')
    a = _store(tmp_path / "a.db", [user, link, link_sub])
    b = _store(tmp_path / "b.db", [user])
    out = chip_smoke.stores_equal(a, b, links=False)
    assert out["clients"] == 1 and out["links_left"] == [2, 0]
    with pytest.raises(AssertionError, match="maxmq-cluster/w1"):
        chip_smoke.stores_equal(a, b)
    c = _store(tmp_path / "c.db",
               [("clients", "cl-1", '{"client_id": "cl-1", "clean": true}')])
    with pytest.raises(AssertionError, match="cl-1"):
        chip_smoke.stores_equal(a, c, links=False)
    # texts that differ only in a wall-clock field, or in what ``normal``
    # drops, are equal; the same text is equal as it is
    d = _store(tmp_path / "d.db", [
        ("clients", "cl-1",
         '{"client_id": "cl-1", "clean": false, "disconnected_at": 5}'),
        ("inflight", "cl-1|1", '{"payload": "00", "tag": 1}')])
    e = _store(tmp_path / "e.db", [
        ("clients", "cl-1",
         '{"disconnected_at": 9, "client_id": "cl-1", "clean": false}'),
        ("inflight", "cl-1|1", '{"payload": "00", "tag": 2}')])
    with pytest.raises(AssertionError, match="inflight"):
        chip_smoke.stores_equal(d, e)

    def untagged(rec):
        rec.pop("tag", None)
        return rec

    assert chip_smoke.stores_equal(d, e, untagged) == {
        "clients": 1, "subscriptions": 0, "retained": 0, "inflight": 1}
    assert chip_smoke.stores_equal(d, d)["inflight"] == 1
