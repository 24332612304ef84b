"""The port's write-behind journal (``hooks/journal.py``) and disk-fault
shim (``hooks/faultstore.py``) held against the JAX package's, on the CPU:

- a numpy-seeded script of writes, durability barriers, injected
  ``storage.*`` and ``disk.*`` faults and crash points (the kill action
  swapped for a recorder) drives both packages' ``WriteBehindStore`` over a
  ``FaultInjectingStore`` over a ``MemoryStore`` and over a ``SQLiteStore``,
  one writer turn at a time (the writer thread stopped, its turns run from
  the test): after every step the backend's contents, the overlay reads,
  which barriers resolved, the breaker's state and every counter are equal;
- the reference's own journal scenarios, ``tests/test_disk_faults.py``
  (all 14, the session-replication crash point on a two-node mesh and the
  registry-versus-call-sites check included) and the journal
  cases of ``tests/test_storage.py`` (from ``:262``), loaded with the port's
  package in place of the JAX package's, each with its own assertions.
"""

import asyncio
import re
import types
from pathlib import Path

import numpy as np
import pytest

import maxmq_tpu.faults as ref_faults
import maxmq_tpu.hooks.faultstore as ref_faultstore
import maxmq_tpu.hooks.journal as ref_journal
import maxmq_tpu.hooks.storage as ref_storage
import maxmq_tpu_torch.faults as port_faults
import maxmq_tpu_torch.hooks.faultstore as port_faultstore
import maxmq_tpu_torch.hooks.journal as port_journal
import maxmq_tpu_torch.hooks.storage as port_storage
from test_torch_broker_engine import port_module, run_scenario, scenario_cases

KITS = {
    "ref": types.SimpleNamespace(faults=ref_faults, faultstore=ref_faultstore,
                                 journal=ref_journal, storage=ref_storage),
    "port": types.SimpleNamespace(faults=port_faults,
                                  faultstore=port_faultstore,
                                  journal=port_journal, storage=port_storage),
}
BUCKETS = ("clients", "retained", "inflight")
# what a step may arm: (site, mode, count)
ARMS = (("storage.put", "raise", 1), ("storage.commit", "raise", 1),
        ("disk.write", "err", 1), ("disk.enospc", "err", 1),
        ("disk.fsync", "err", 1), ("disk.latency", "hang", 1),
        ("crash.at#pre_fsync", "kill", 1),
        ("crash.at#post_fsync_pre_ack", "kill", 1))
# counters and state that do not depend on the clock
COUNTERS = ("commits", "commit_failures", "put_failures", "ops_written",
            "coalesced", "overflows", "barrier_waits",
            "barriers_released_degraded", "last_batch_ops",
            "largest_batch_ops", "dirty", "fsync_failures",
            "enospc_failures", "backend_reopens", "disk_full",
            "breaker_state", "breaker_trips", "breaker_recoveries",
            "queue_depth", "queued_bytes_now", "committed_seq",
            "over_watermark", "_poisoned")


def script(seed: int, n: int = 160) -> list:
    """Steps from a numpy seed: writes (put, delete, delete_prefix) over a
    few keys of three buckets, barriers, writer turns, fault armings."""
    rng = np.random.default_rng(seed)
    steps = []
    for _ in range(n):
        r = rng.random()
        bucket = BUCKETS[int(rng.integers(len(BUCKETS)))]
        key = f"c{int(rng.integers(6))}|{int(rng.integers(4))}"
        if r < 0.40:
            steps.append(("put", bucket, key, "v" * int(rng.integers(1, 40))))
        elif r < 0.48:
            steps.append(("delete", bucket, key))
        elif r < 0.52:
            steps.append(("delete_prefix", bucket, key.split("|")[0] + "|"))
        elif r < 0.62:
            steps.append(("barrier",))
        elif r < 0.90:
            steps.append(("turn",))
        else:
            steps.append(("arm", *ARMS[int(rng.integers(len(ARMS)))]))
    return steps + [("turn",)] * 40


def journal(kit, inner: str, tmp_path, **kw):
    """A ``WriteBehindStore`` of ``kit`` over its fault shim over a
    ``MemoryStore`` or a ``SQLiteStore``, its writer thread stopped (the
    test runs the writer's turns)."""
    if inner == "memory":
        backend = kit.storage.MemoryStore()
    else:
        backend = kit.storage.SQLiteStore(str(tmp_path / f"{id(kit)}.db"))
    st = kit.journal.WriteBehindStore(
        kit.faultstore.FaultInjectingStore(backend), batch_ms=0,
        backoff_s=0.0, backoff_max_s=0.0, **kw)
    st._stopped = True
    st._work.set()
    st._thread.join(timeout=10)
    assert not st._thread.is_alive()
    st._stopped = False
    return st


def snapshot(st, barriers: list, kills: list) -> dict:
    inner = st.inner.inner
    return {"counters": {k: getattr(st, k) for k in COUNTERS},
            "backend": {b: inner.all(b) for b in BUCKETS},
            "overlay": {b: st.all(b) for b in BUCKETS},
            "get": st.get("retained", "c0|0"),
            "barriers": [None if f is None else f.done() for f in barriers],
            "kills": len(kills)}


async def drive(kit, st, steps) -> list:
    loop = asyncio.get_running_loop()
    barriers, kills, out = [], [], []
    kit.faults.clear()
    kill_fn = kit.faults.REGISTRY.kill_fn
    kit.faults.REGISTRY.kill_fn = lambda: kills.append(1)
    try:
        for step in steps:
            op = step[0]
            if op in ("put", "delete", "delete_prefix"):
                getattr(st, op)(*step[1:])
            elif op == "barrier":
                barriers.append(st.barrier(loop))
            elif op == "turn":
                if st.queue_depth:
                    st._writer_turn()
            else:
                site, mode, count = step[1:]
                kit.faults.arm(site, mode, count, delay_s=0.001)
            await asyncio.sleep(0)
            await asyncio.sleep(0)
            out.append(snapshot(st, barriers, kills))
    finally:
        kit.faults.clear()
        kit.faults.REGISTRY.kill_fn = kill_fn
        st.close()
    return out


@pytest.mark.parametrize("inner", ["memory", "sqlite"])
@pytest.mark.parametrize("policy", ["always", "batched"])
@pytest.mark.parametrize("seed", [1, 2, 3])
async def test_journal_step_for_step(inner, policy, seed, tmp_path):
    steps = script(seed)
    got = {}
    for name, kit in KITS.items():
        (tmp_path / name).mkdir()
        st = journal(kit, inner, tmp_path / name, policy=policy,
                     breaker_threshold=3, queue_bytes=600)
        got[name] = await drive(kit, st, steps)
    for i, (want, have) in enumerate(zip(got["ref"], got["port"])):
        assert have == want, (i, steps[i])
    last = got["port"][-1]["counters"]
    assert last["commits"] and last["commit_failures"]
    assert last["breaker_trips"] and last["barrier_waits"] or \
        policy != "always"


def test_journal_constants_and_classification_equal_the_reference():
    for name in ("SQLITE_SYNC_BY_POLICY", "POLICIES", "BREAKER_CLOSED",
                 "BREAKER_OPEN", "BREAKER_HALF_OPEN"):
        assert getattr(port_journal, name) == getattr(ref_journal, name)
    import errno
    import sqlite3
    for exc in (OSError(errno.ENOSPC, "x"), OSError(errno.EIO, "x"),
                sqlite3.OperationalError("database or disk is full"),
                OSError("fsync failed"), ValueError("boom")):
        assert (port_journal.classify_commit_failure(exc)
                == ref_journal.classify_commit_failure(exc))
    assert (port_journal.classify_commit_failure(port_faultstore.FsyncFailed())
            == ref_journal.classify_commit_failure(ref_faultstore.FsyncFailed())
            == "fsync")
    assert (port_journal.classify_commit_failure(port_faultstore.DiskFull())
            == "enospc")


def test_fault_sites_equal_the_reference():
    for name in ("STORAGE_PUT", "STORAGE_COMMIT", "DISK_WRITE", "DISK_ENOSPC",
                 "DISK_FSYNC", "DISK_LATENCY", "CRASH_POINTS"):
        assert getattr(port_faults, name) == getattr(ref_faults, name)


# -- the reference's scenarios -----------------------------------------------

DISK = port_module("test_disk_faults.py", "torch_port_disk_faults")
DISK_CASES = scenario_cases(DISK, 1, 455)
SYSTEM = port_module("test_broker_system.py", "torch_port_broker_system")
STORAGE = port_module(
    "test_storage.py", "torch_port_storage",
    replace=(("from test_broker_system import connect, running_broker",
              "from torch_port_broker_system import connect, running_broker"),
             ))
STORAGE_CASES = scenario_cases(STORAGE, 262, 630)


def test_every_journal_scenario_is_ported():
    assert len(DISK_CASES) == 14 and len(STORAGE_CASES) == 15


@pytest.fixture
def port_faults_clean():
    port_faults.clear()
    kill_fn = port_faults.REGISTRY.kill_fn
    yield
    port_faults.clear()
    port_faults.REGISTRY.kill_fn = kill_fn


async def run_case(mod, name, kwargs, tmp_path, monkeypatch):
    fn = getattr(mod, name)
    if "monkeypatch" in fn.__code__.co_varnames[:fn.__code__.co_argcount]:
        kwargs = dict(kwargs, monkeypatch=monkeypatch)
    await run_scenario(fn, kwargs, tmp_path)


@pytest.mark.parametrize("name,kwargs", DISK_CASES,
                         ids=[n for n, _k in DISK_CASES])
async def test_disk_faults_scenario_on_the_port(name, kwargs, tmp_path,
                                                monkeypatch,
                                                port_faults_clean):
    await run_case(DISK, name, kwargs, tmp_path, monkeypatch)


@pytest.mark.parametrize("name,kwargs", STORAGE_CASES,
                         ids=[n for n, _k in STORAGE_CASES])
async def test_storage_journal_scenario_on_the_port(name, kwargs, tmp_path,
                                                    monkeypatch,
                                                    port_faults_clean):
    await run_case(STORAGE, name, kwargs, tmp_path, monkeypatch)


def test_crash_points_have_call_sites_in_the_port():
    """The reference's registry-versus-call-sites check on the port: every
    crash point has a call site (the session-replication flush in
    ``cluster/sessions.py`` included), and every call site is
    registered."""
    called = set()
    for py in Path(port_faults.__file__).parent.rglob("*.py"):
        if py.name != "faults.py":
            called |= set(re.findall(r'crash_point\(\s*"([a-z_]+)"',
                                     py.read_text()))
    assert called == set(port_faults.CRASH_POINTS)
