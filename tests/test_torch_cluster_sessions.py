"""The port's federated sessions (``maxmq_tpu_torch/cluster/sessions.py``)
against the JAX package's.

- ``tests/test_cluster_sessions.py``, all 18 scenarios, loaded with the
  port's package in place of the JAX package's (``port_module``), with the
  reference's own assertions and its ``session_sync="always"``: the cover
  and share-ledger units, replication and journaling, the dual-CONNECT
  split brain, the offline-inflight takeover, clean-start purges,
  cluster-wide ``$share``, the sync and takeover faults, the barrier, the
  live-link resync, a malformed replicated row, tombstones, the $SYS tree
  and metrics, and the SIGKILL failover of two ``run_server`` processes;
- unit tests from numpy seeds, each input through both packages: the
  ``SessionEntry`` codecs byte for byte, the wire envelopes, the re-owned
  entry of a claim, the judge's rank, tombstone epochs, the dead-owner
  sweep with every link up (which the port skips) and with one down, the
  fault sites, and the session metrics' names and order;
- the port's two repairs: the paced resync (equal to the reference's
  below the link queue's bound, converging past it, where the
  reference's does not) and the replica's fence ordered by the origin's
  boot epoch (a restarted owner's window replicates; the reference's
  replica stays stale).
"""

import asyncio
import json
import time
import types

import numpy as np
import pytest

from maxmq_tpu import metrics as j_metrics
from maxmq_tpu.cluster import sessions as j_sess
from maxmq_tpu_torch import faults as port_faults
from maxmq_tpu_torch import metrics as t_metrics
from maxmq_tpu_torch.cluster import sessions as t_sess
from test_torch_broker_engine import port_module, run_scenario, scenario_cases

SESSIONS = port_module("test_cluster_sessions.py", "torch_port_cluster_sessions")
SESSION_CASES = scenario_cases(SESSIONS, 1, 10_000)
PKGS = {"ref": j_sess, "port": t_sess}


def test_every_session_scenario_is_ported():
    assert len(SESSION_CASES) == 18


@pytest.fixture
def clean_port_faults():
    port_faults.clear()
    yield
    port_faults.clear()
    port_faults.REGISTRY.reset_clock()


@pytest.mark.parametrize("name,kwargs", SESSION_CASES,
                         ids=[n for n, _k in SESSION_CASES])
async def test_session_scenario_on_the_port(name, kwargs, tmp_path,
                                            clean_port_faults):
    await run_scenario(getattr(SESSIONS, name), kwargs, tmp_path)


test_session_scenario_on_the_port._async_timeout = 120


# -- units against the JAX package ---------------------------------------------

PEERS = ("A", "B", "C", "D")
NODE = "B"
CIDS = [f"c{i}" for i in range(12)]


class FakeLink:
    def __init__(self, peer: str, connected: bool, sent: list) -> None:
        self.peer, self.connected, self.sent = peer, connected, sent
        self.outbound = types.SimpleNamespace(qsize=lambda: 0)

    def send_session(self, topic, payload, on_ack=None) -> bool:
        if not self.connected:
            return False        # as BridgeLink's: refused while down
        self.sent.append((self.peer, topic, payload, on_ack is not None))
        return True


class FakeShares:
    group_count = 0

    def __init__(self) -> None:
        self.calls = []

    def set_member(self, owner, key, n) -> None:
        self.calls.append((owner, tuple(key), n))


def federation(pkg: str, up: dict[str, bool], **kw):
    """A ``SessionFederation`` of package ``pkg`` on a stand-in manager
    and broker (no loop, no store): links to the peers in ``up`` (peer ->
    connected), and recorders for what it sends, fires and rehomes."""
    sent, fired, rehomed = [], [], []
    broker = types.SimpleNamespace(
        boot_epoch=7, _storage_hook=None, loop=None, tracer=None,
        clients={}, _will_delays={},
        _fire_will=lambda client, pkt: fired.append(
            (pkt.topic, bytes(pkt.payload), pkt.fixed.qos, pkt.fixed.retain,
             pkt.origin)))
    last_seen = {p: 100.0 + i for i, p in enumerate(PEERS)}
    mgr = types.SimpleNamespace(
        broker=broker, node_id=NODE, max_hops=3, log=None,
        links={p: FakeLink(p, c, sent) for p, c in up.items()},
        routes=types.SimpleNamespace(shares=FakeShares()),
        membership=types.SimpleNamespace(get=lambda p: types.SimpleNamespace(
            last_seen=last_seen.get(p, 0.0))),
        link_deadline=lambda peer, floor: floor,
        rehome_for_takeover=lambda dead, winner, filters: rehomed.append(
            (dead, winner, list(filters))))
    fed = PKGS[pkg].SessionFederation(mgr, **kw)
    fed._wall = lambda: 1_000.0
    fed._started_mono = 50.0
    return fed, sent, fired, rehomed


def rand_subs(rng) -> list:
    out = []
    for _ in range(int(rng.integers(0, 3))):
        f = "/".join(("s", str(int(rng.integers(0, 4))),
                      ("+", "#", "x")[int(rng.integers(0, 3))]))
        out.append([f, int(rng.integers(0, 3)), int(rng.integers(0, 2)),
                    int(rng.integers(0, 2)), int(rng.integers(0, 3)),
                    int(rng.integers(0, 5))])
    if rng.random() < 0.3:
        out.append(["$share/g1/s/q", 1, 0, 0, 0, 0])
    return out


def rand_will(rng):
    r = rng.random()
    if r < 0.4:
        return None
    w = [f"will/{int(rng.integers(0, 9))}", bytes(rng.integers(
        0, 256, int(rng.integers(0, 6)), dtype=np.uint8)).hex(),
        int(rng.integers(0, 3)), int(rng.integers(0, 2)),
        float(rng.choice([0.0, 0.5, 2.0, 30.0]))]
    if r > 0.7:
        w.append(float(rng.choice([990.0, 999.5, 1_000.0, 1_050.0])))
    return w


def rand_entry_args(rng, owner=None) -> tuple:
    subs = rand_subs(rng)
    shares = [["g1", s[0]] for s in subs if s[0].startswith("$share/")]
    return (CIDS[int(rng.integers(0, len(CIDS)))],
            owner or PEERS[int(rng.integers(0, len(PEERS)))],
            int(rng.integers(1, 6)), int(rng.integers(0, 4)),
            int(rng.integers(0, 100)), bool(rng.integers(0, 2)),
            int(rng.choice([4, 5])), bool(rng.integers(0, 2)), subs, shares,
            (int(rng.integers(0, 5)), int(rng.integers(0, 1 << 16))),
            rand_will(rng))


def ledger_state(fed) -> dict:
    return {cid: (e.meta_json(), sorted(e.inflight.items()), list(e.pubrec),
                  e.token)
            for cid, e in fed.ledger.items()}


# the port's own counters (its held relays), left out of comparisons
PORT_ONLY = ("relays_held", "relays_dropped")


def counters(fed) -> dict:
    return {k: v for k, v in vars(fed).items()
            if isinstance(v, (int, float, str, bool)) and k not in PORT_ONLY}


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_session_entry_codecs_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(300):
        args = rand_entry_args(rng)
        ref, port = j_sess.SessionEntry(*args), t_sess.SessionEntry(*args)
        assert port.meta_json() == ref.meta_json()
        assert port.token == ref.token
        assert port.share_keys() == ref.share_keys()
        assert json.dumps(t_sess._entry_update_dict(port)) == \
            json.dumps(j_sess._entry_update_dict(ref))
        raw = ref.meta_json()
        back = (t_sess.SessionEntry.from_meta_json(raw),
                j_sess.SessionEntry.from_meta_json(raw))
        assert back[0].meta_json() == back[1].meta_json() == raw
    for name in ("SESS_WIRE_VERSION", "SYNC_POLICIES", "REPLICA_SWEEP_S",
                 "WILL_FIRE_GRACE_S", "SYNC_LAG_WINDOW", "OPS_PER_MESSAGE",
                 "RESYNC_DELAY_S", "SESS_BUCKET", "INFLIGHT_BUCKET",
                 "TOMBSTONES_MAX"):
        assert getattr(t_sess, name) == getattr(j_sess, name), name


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_reowned_entry_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(200):
        args = rand_entry_args(rng)
        token = (int(rng.integers(1, 9)), int(rng.integers(0, 4)),
                 PEERS[int(rng.integers(0, len(PEERS)))])
        purge = bool(rng.integers(0, 2))
        cur = {"ref": j_sess.SessionEntry(*args),
               "port": t_sess.SessionEntry(*args)}
        for with_cur in (True, False):
            got = {pkg: PKGS[pkg].SessionFederation._reowned_entry(
                args[0], cur[pkg] if with_cur else None, token, purge)
                for pkg in PKGS}
            assert got["port"].meta_json() == got["ref"].meta_json()
            assert got["port"].will is None


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_judge_rank_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(100):
        up = {p: bool(rng.integers(0, 2)) for p in PEERS
              if p != NODE and rng.random() < 0.8}
        feds = {pkg: federation(pkg, up)[0] for pkg in PKGS}
        for dead in PEERS:
            assert feds["port"]._judge_rank(dead) == \
                feds["ref"]._judge_rank(dead), (up, dead)


def scripted_inbound(rng) -> tuple:
    """One random inbound ``$cluster/sess`` message: (kind, origin, d)."""
    kind = str(rng.choice(["up", "claim", "purge", "willfire", "infl",
                           "state"]))
    args = rand_entry_args(rng)
    cid, origin = args[0], args[1]
    if origin == NODE:
        origin = "A"
    se, be = args[2], args[3]
    if kind == "up":
        e = j_sess.SessionEntry(*args)
        return kind, origin, j_sess._entry_update_dict(e)
    if kind == "claim":
        return kind, origin, {"cid": cid, "se": se, "be": be,
                              "purge": int(rng.integers(0, 2)),
                              "pull": int(rng.integers(0, 2))}
    if kind in ("purge", "willfire"):
        d = {"cid": cid, "se": se, "be": be}
        if rng.random() < 0.5:
            d["ow"] = PEERS[int(rng.integers(0, len(PEERS)))]
        return kind, origin, d
    if kind == "infl":
        ops = []
        for _ in range(int(rng.integers(1, 5))):
            pid = int(rng.integers(1, 8))
            op = str(rng.choice(["set", "del", "rec", "recdel"]))
            ops.append([cid, pid, op] + ([f'{{"m":{pid}}}'] if op == "set"
                                          else []))
        return kind, origin, {"ops": ops, "dig": {cid: [len(ops), se]}}
    return kind, origin, {"cid": cid, "se": se, "be": be, "subs": []}


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5])
def test_scripted_wire_equals_the_reference(seed):
    """A seeded script of inbound updates, claims, purges, will stand-downs,
    inflight ops and state handoffs, and of local claims, updates and
    purges, through both packages' federations: after every step the
    ledgers (entries byte for byte, inflight, PUBREC-pending, tokens), the
    tombstone epochs, every counter, the envelopes sent (topic, payload
    bytes, ack) and the rehomed forwards are equal."""
    rng = np.random.default_rng(seed)
    up = {"A": True, "C": True, "D": True}
    feds = {pkg: federation(pkg, up, sync="always") for pkg in PKGS}
    seq = 0
    for _ in range(400):
        r = rng.random()
        if r < 0.7:
            kind, origin, d = scripted_inbound(rng)
            seq += 1
            for fed, *_rest in feds.values():
                fed._dispatch(kind, origin, json.loads(json.dumps(d)), seq)
        elif r < 0.85:
            args = rand_entry_args(rng, owner=NODE)
            for pkg, (fed, *_rest) in feds.items():
                fed._apply_entry(PKGS[pkg].SessionEntry(*args))
                fed._send_claim(args[0], args[2], purge=bool(args[7]),
                                pull=not args[7])
                fed._broadcast("up", PKGS[pkg]._entry_update_dict(
                    fed.ledger[args[0]]), ack=True)
        else:
            cid = CIDS[int(rng.integers(0, len(CIDS)))]
            for fed, *_rest in feds.values():
                fed.note_purge(cid)
        (pf, ps, pw, pr), (rf, rs, rw, rr) = feds["port"], feds["ref"]
        assert ledger_state(pf) == ledger_state(rf)
        assert pf._tombstones == rf._tombstones
        assert counters(pf) == counters(rf)
        assert ps == rs and pw == rw and pr == rr
        assert pf.manager.routes.shares.calls == rf.manager.routes.shares.calls
        assert pf._peer_ack_target == rf._peer_ack_target
    assert sum(1 for _p, t, _b, _a in ps if t.endswith("/claim")) > 10
    assert pf.purges and pf.claims_rejected and pf.sessions_lost


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_tombstone_epochs_equal_the_reference(seed):
    """Purge tombstones: a re-created session claims above its tombstone,
    a live entry supersedes the tombstone, and the bound evicts the
    oldest first, in both packages."""
    rng = np.random.default_rng(seed)
    feds = {pkg: federation(pkg, {"A": True})[0] for pkg in PKGS}
    for fed in feds.values():
        fed.manager.links = {}
    for _ in range(600):
        cid = f"t{int(rng.integers(0, 40))}"
        epoch = int(rng.integers(1, 30))
        live = rng.random() < 0.2
        for pkg, fed in feds.items():
            if live:
                fed._apply_entry(PKGS[pkg].SessionEntry(cid, "A", epoch))
            else:
                fed._note_tombstone(cid, epoch)
    assert feds["port"]._tombstones == feds["ref"]._tombstones
    assert list(feds["port"]._tombstones) == list(feds["ref"]._tombstones)
    for pkg in PKGS:
        feds[pkg].ledger.clear()
    for fed in feds.values():
        fed._tombstones = {}
        for i in range(t_sess.TOMBSTONES_MAX + 50):
            fed._note_tombstone(f"x{i}", i)
    assert list(feds["port"]._tombstones) == list(feds["ref"]._tombstones)
    assert len(feds["port"]._tombstones) == t_sess.TOMBSTONES_MAX


def seeded_ledger(rng, feds) -> None:
    """The same remote-owned entries, with their disconnect instants, in
    every federation of ``feds``."""
    for _ in range(int(rng.integers(20, 60))):
        args = rand_entry_args(rng)
        if args[1] == NODE:
            continue
        seen = float(rng.choice([0.0, 90.0, 99.0, 100.5]))
        for pkg, fed in feds.items():
            e = PKGS[pkg].SessionEntry(*args)
            e.disconnected_seen = seen if not e.connected else 0.0
            fed.ledger[e.cid] = e


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5, 6])
def test_dead_owner_sweep_equals_the_reference(seed):
    """The dead-owner sweep over the same ledger and link states, at a
    series of instants: the wills fired (in order), the purges and
    stand-downs broadcast, the share accounting and the ledger after each
    sweep are the reference's, with every link up (the port skips the
    walk) and with some down."""
    rng = np.random.default_rng(seed)
    acted = 0
    for up in ({"A": True, "C": True, "D": True},
               {"A": False, "C": True, "D": True},
               {"A": False, "C": False, "D": True}, {}):
        feds = {pkg: federation(pkg, dict(up), replica_expiry_s=float(
            rng.choice([0.0, 5.0, 40.0]))) for pkg in PKGS}
        expiry = feds["ref"][0].replica_expiry
        feds["port"][0].replica_expiry = expiry
        seeded_ledger(rng, {pkg: f[0] for pkg, f in feds.items()})
        for now in (100.2, 101.0, 102.5, 104.0, 110.0, 140.0, 200.0):
            for fed, *_rest in feds.values():
                fed._sweep(now)
            (pf, ps, pw, _pr), (rf, rs, rw, _rr) = feds["port"], feds["ref"]
            assert ledger_state(pf) == ledger_state(rf), (up, now)
            assert pw == rw and ps == rs
            assert counters(pf) == counters(rf)
            assert pf._tombstones == rf._tombstones
        if all(up.values()):
            assert not pw and not ps and pf.replica_expiries == 0
        acted += rf.wills_fired + rf.replica_expiries
    assert acted


def test_fault_sites_fire_as_the_reference():
    """``cluster.session_sync`` and ``cluster.takeover``, keyed and plain,
    armed with the same specs in both registries, trip on the same hits
    with the same (mode, delay)."""
    from maxmq_tpu import faults as j_faults

    assert (port_faults.CLUSTER_SESSION_SYNC, port_faults.CLUSTER_TAKEOVER) \
        == (j_faults.CLUSTER_SESSION_SYNC, j_faults.CLUSTER_TAKEOVER)
    rng = np.random.default_rng(9)
    try:
        for mod in (port_faults, j_faults):
            mod.clear()
            mod.arm_from_spec("cluster.session_sync#A:hang:3:0.2:1,"
                              "cluster.takeover#C:drop:2:0.05:0,"
                              "cluster.session_sync:drop:4:0.05:2")
            mod.arm(mod.CLUSTER_TAKEOVER, "raise", 2, skip=1)
        keys = [("cluster.session_sync", "A"), ("cluster.session_sync", "C"),
                ("cluster.takeover", "C"), ("cluster.takeover", "A")]
        for _ in range(60):
            site, key = keys[int(rng.integers(0, len(keys)))]
            got = []
            for mod in (port_faults, j_faults):
                try:
                    got.append(mod.fire_detail(site, key=key))
                except mod.InjectedFault:
                    got.append("raised")
            assert got[0] == got[1], (site, key)
        assert dict(port_faults.REGISTRY.fired) == dict(j_faults.REGISTRY.fired)
    finally:
        port_faults.clear()
        j_faults.clear()


def test_session_metrics_equal_the_reference():
    """``_register_session_metrics``: the reference's series, in its order,
    with its help texts and values, on a federation with a seeded ledger."""
    rng = np.random.default_rng(4)
    pages = {}
    feds = {pkg: federation(pkg, {"A": True})[0] for pkg in PKGS}
    seeded_ledger(rng, feds)
    for pkg, mod in (("ref", j_metrics), ("port", t_metrics)):
        feds[pkg].takeovers, feds[pkg].sync_acks = 3, 11
        reg = mod.Registry()
        mod._register_session_metrics(reg, feds[pkg].manager)
        feds[pkg].manager.sessions = feds[pkg]
        reg = mod.Registry()
        mod._register_session_metrics(reg, feds[pkg].manager)
        pages[pkg] = reg.expose()
    assert pages["port"] == pages["ref"]
    names = [ln.split()[2] for ln in pages["port"].splitlines()
             if ln.startswith("# TYPE")]
    assert names[:3] == ["maxmq_cluster_session_ledger",
                         "maxmq_cluster_session_local",
                         "maxmq_cluster_session_share_groups"]
    assert len(names) == 3 + 23
    assert "maxmq_cluster_session_takeovers_total 3" in pages["port"]


# -- the paced resync (past the link queue's bound) -----------------------------

async def resync_pair(pkg: str, n: int, wait_s: float) -> dict:
    """Two nodes of package ``pkg``, each on a ``MemoryStore``; A owns ``n``
    offline sessions before the link comes up; B's ledger and its
    ``cluster_sessions`` rows after the resync (or after ``wait_s``)."""
    import importlib

    base = "maxmq_tpu" if pkg == "ref" else "maxmq_tpu_torch"
    bmod = importlib.import_module(f"{base}.broker")
    cmod = importlib.import_module(f"{base}.cluster")
    hmod = importlib.import_module(f"{base}.hooks")
    smod = importlib.import_module(f"{base}.hooks.storage")
    kw = {} if pkg == "ref" else {"device": "cpu"}
    brokers, ports, mgrs = {}, {}, {}
    try:
        for node in "AB":
            b = bmod.Broker(bmod.BrokerOptions(
                capabilities=bmod.Capabilities(sys_topic_interval=0), **kw))
            b.add_hook(hmod.AllowHook())
            b.add_hook(smod.StorageHook(smod.MemoryStore()))
            lst = b.add_listener(bmod.TCPListener("t", "127.0.0.1:0"))
            await b.serve()
            brokers[node] = b
            ports[node] = lst._server.sockets[0].getsockname()[1]
        for node, peer in (("A", "B"), ("B", "A")):
            mgrs[node] = cmod.ClusterManager(
                brokers[node], node,
                [cmod.PeerSpec(peer, "127.0.0.1", ports[peer])],
                backoff_initial_s=0.05)
            brokers[node].attach_cluster(mgrs[node])
        for i in range(n):
            mgrs["A"].sessions._apply_entry(cmod.SessionEntry(
                f"s{i}", "A", 1 + i % 3, 2, i % 50, bool(i % 2), 5, False,
                [[f"r/{i}/+", i % 3, 0, 0, 0, i % 7]], [], (0, 0)))
        t0 = time.monotonic()
        for m in mgrs.values():
            await m.start()
        while (len(mgrs["B"].sessions.ledger) < n
               and time.monotonic() - t0 < wait_s):
            await asyncio.sleep(0.05)
        hook = brokers["B"]._storage_hook
        return {"ledger": {c: e.meta_json()
                           for c, e in mgrs["B"].sessions.ledger.items()},
                "rows": hook.store.all("cluster_sessions"),
                "failures": mgrs["A"].sessions.sync_send_failures,
                "s": time.monotonic() - t0}
    finally:
        for b in brokers.values():
            await b.close()


async def test_paced_resync_equals_the_reference_below_the_bound():
    """Below the link queue's bound both packages' resyncs converge the
    peer, to the same ledger and the same journal rows."""
    got = {pkg: await resync_pair(pkg, 3_000, 30) for pkg in PKGS}
    assert len(got["port"]["ledger"]) == 3_000
    assert got["port"]["ledger"] == got["ref"]["ledger"]
    assert got["port"]["rows"] == got["ref"]["rows"]
    assert got["port"]["failures"] == got["ref"]["failures"] == 0


async def test_paced_resync_converges_past_the_link_queue():
    """Past ``LINK_QUEUE_MAX`` owned sessions the port's paced resync
    converges the peer with no refused send; the reference's, given three
    times as long, has not (the link refused the rest of its one-call
    resync, and each gap-healing resync starts over)."""
    from maxmq_tpu_torch.cluster.bridge import LINK_QUEUE_MAX

    n = LINK_QUEUE_MAX + 2_000
    port = await resync_pair("port", n, 60)
    assert len(port["ledger"]) == n and port["failures"] == 0
    assert set(port["rows"]) == set(port["ledger"])
    ref = await resync_pair("ref", n, max(3 * port["s"], 3.0))
    assert len(ref["ledger"]) < n and ref["failures"] > 0
    assert {c: port["ledger"][c] for c in ref["ledger"]} == ref["ledger"]


test_paced_resync_converges_past_the_link_queue._async_timeout = 120


def envelope(origin: str, epoch: int, seq: int, d: dict) -> bytes:
    return json.dumps({"v": 1, "o": origin, "e": epoch, "q": seq, "h": 1,
                       "d": d}).encode()


async def test_restarted_owner_window_replicates():
    """A replica orders an origin's messages by its boot epoch, then its
    seq: after the owner restarts (a new epoch, its seqs start over) its
    inflight chunks apply at once. The reference orders by the seq alone
    and fences them off until the new seqs pass the old incarnation's, so
    its replica of the window goes stale. Before the restart both
    packages hold the same replica."""
    got = {}
    for pkg in PKGS:
        fed, sent, _w, _r = federation(pkg, {"A": True, "C": True})
        entry = PKGS[pkg].SessionEntry("s1", "A", 1, 5, subs=[["t/#", 1, 0,
                                                                0, 0, 0]])
        pkt = types.SimpleNamespace
        msgs = [("up", envelope("A", 5, 900, PKGS[pkg]._entry_update_dict(
                    entry))),
                ("infl", envelope("A", 5, 901, {
                    "ops": [["s1", 1, "set", '{"m":1}']],
                    "dig": {"s1": [1, 1]}}))]
        for kind, payload in msgs:
            await fed.handle_inbound(
                "A", ["$cluster", "sess", "A", kind], pkt(payload=payload))
        before = ledger_state(fed)
        # the owner restarts: epoch 6, its seqs from 1 again
        for kind, payload in (
                ("up", envelope("A", 6, 1, PKGS[pkg]._entry_update_dict(
                    entry))),
                ("infl", envelope("A", 6, 2, {
                    "ops": [["s1", 2, "set", '{"m":2}'],
                            ["s1", 1, "del"]],
                    "dig": {"s1": [1, 2]}}))):
            await fed.handle_inbound(
                "A", ["$cluster", "sess", "A", kind], pkt(payload=payload))
        got[pkg] = (before, ledger_state(fed), len(sent))
    assert got["port"][0] == got["ref"][0]
    assert got["port"][2] == got["ref"][2]      # the same relays to C
    port_entry = got["port"][1]["s1"]
    assert port_entry[1] == [(2, '{"m":2}')]
    assert json.loads(port_entry[0])["dig"] == [1, 2]
    assert got["ref"][1]["s1"][1] == [(1, '{"m":1}')]   # stale


def test_relay_for_a_down_link_is_held_until_it_comes_up():
    """B relays A's messages to C. With B's link to C not yet up, the
    reference's relay fails (a counted refused send) and is never sent
    again; the port holds it, in order, and sends it as the link comes
    up, before its own resync."""
    got = {}
    for pkg in PKGS:
        fed, sent, _w, _r = federation(pkg, {"A": True, "C": False})
        for seq in (1, 2, 3):
            fed._relay("up", {"v": 1, "o": "A", "e": 5, "q": seq, "h": 1,
                              "d": {"cid": f"x{seq}"}}, exclude={"A"})
        before = list(sent)
        link = fed.manager.links["C"]
        link.connected = True
        fed.on_link_up(link)
        got[pkg] = (before, [(p, t, json.loads(b)["q"]) for p, t, b, _a
                             in sent], fed.sync_send_failures, fed.relays)
    assert got["port"][0] == [] and got["ref"][0] == []
    assert got["port"][1] == [("C", "$cluster/sess/B/up", q)
                              for q in (1, 2, 3)]
    assert got["ref"][1] == []              # lost for good
    assert got["ref"][2] == 3 and got["port"][2] == 0
    assert got["port"][3] == got["ref"][3] == 3


async def test_resync_window_ignores_a_dead_connections_unacked_sends():
    """Messages sent before a link-up that the peer never acknowledged (a
    dead connection's, or sends refused while the link was down, which
    still raise the ack target) do not hold the new resync's window: the
    walk ships ``RESYNC_WINDOW`` messages at once, then more as the
    peer's acks come."""
    fed, sent, _w, _r = federation("port", {"A": True})
    fed.broker.loop = asyncio.get_running_loop()
    fed._started = True
    fed._next_seq = fed._peer_ack_target["A"] = 10_000   # never acked
    n = t_sess.RESYNC_WINDOW * 3
    for i in range(n):
        fed.ledger[f"own{i}"] = t_sess.SessionEntry(f"own{i}", NODE, 1)

    def seqs() -> list:
        return [json.loads(b)["q"] for _p, t, b, ack in sent
                if t.endswith("/up") and ack]

    fed.on_link_up(fed.manager.links["A"])
    assert len(seqs()) == t_sess.RESYNC_WINDOW
    fed._on_sync_ack("A", seqs()[-1], True)     # the peer caught up
    await asyncio.sleep(0)
    assert len(seqs()) == 2 * t_sess.RESYNC_WINDOW
    for _ in range(4):
        fed._on_sync_ack("A", seqs()[-1], True)
        await asyncio.sleep(0)
    assert len(seqs()) == n and len(set(seqs())) == n
    fed.close()
