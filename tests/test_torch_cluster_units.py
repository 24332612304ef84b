"""The port's cluster parts that compute without a broker, held equal to
the JAX package's on the same inputs, every input from a numpy seed:
filter subsumption and the minimal route cover (``IncrementalCover``
under add/remove sequences, and at a third of ``mixed_100k``), the route
snapshot and delta codecs byte for byte (the predicate-annotated form
too) and their errors, ``RouteTable`` over snapshot, delta and flush
streams, ``ShareLedger`` owners in pin and weighted modes, ``DedupWindow``,
``Membership``, ``parse_peers`` and ``valid_node_id`` with their errors,
the fault registry's WAN shapes (``ShapeSpec`` draws and departures) and
the keys ``partition``, ``heal``, ``shape`` and ``unshape`` arm, and the
manager's session federation, attached with the reference's settings."""

import numpy as np
import pytest

import chip_smoke
from maxmq_tpu import faults as j_faults
from maxmq_tpu.broker import Broker as JBroker
from maxmq_tpu.cluster import manager as j_manager
from maxmq_tpu.cluster import membership as j_members
from maxmq_tpu.cluster import routes as j_routes
from maxmq_tpu_torch import faults as t_faults
from maxmq_tpu_torch.broker import Broker, BrokerOptions
from maxmq_tpu_torch.cluster import (ClusterManager, PeerSpec, manager as
                                     t_manager, membership as t_members,
                                     routes as t_routes)

SEEDS = [1, 2, 3, 4, 5, 6]
LEVELS = ["a", "b", "c", "+", "d0", "e"]


def rand_filter(rng, depth: int = 4) -> str:
    d = int(rng.integers(1, depth + 1))
    lv = [LEVELS[int(i)] for i in rng.integers(0, len(LEVELS), d)]
    if rng.random() < 0.3:
        lv = lv[:int(rng.integers(0, d))] + ["#"]
    return "/".join(lv)


def rand_topic(rng) -> str:
    d = int(rng.integers(1, 5))
    return "/".join(("a", "b", "c", "d0", "e")[int(i)]
                    for i in rng.integers(0, 5, d))


# -- subsumption and covers -----------------------------------------------


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_filter_subsumes_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(2_000):
        g, f = rand_filter(rng), rand_filter(rng)
        assert (t_routes.filter_subsumes(g, f)
                == j_routes.filter_subsumes(g, f)), (g, f)


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_minimal_cover_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        fs = [rand_filter(rng) for _ in range(int(rng.integers(0, 40)))]
        assert t_routes.minimal_cover(fs) == j_routes.minimal_cover(fs)


@pytest.mark.parametrize("seed", SEEDS)
def test_incremental_cover_equals_the_reference(seed):
    """Seeded add/remove sequences (refcounts, re-exposed witnesses,
    promotions that demote): the port's cover equals the reference's and
    ``minimal_cover`` of the live set after every step."""
    rng = np.random.default_rng(seed)
    port, ref, live = t_routes.IncrementalCover(), \
        j_routes.IncrementalCover(), {}
    for _ in range(600):
        if live and rng.random() < 0.45:
            keys = sorted(live)
            f = keys[int(rng.integers(len(keys)))]
            live[f] -= 1
            if not live[f]:
                del live[f]
            port.remove(f)
            ref.remove(f)
        else:
            f = rand_filter(rng)
            live[f] = live.get(f, 0) + 1
            port.add(f)
            ref.add(f)
        assert port.cover == ref.cover == j_routes.minimal_cover(live)
        assert port.refs == ref.refs
    port.remove("never/added")
    assert port.cover == ref.cover


def test_incremental_cover_at_a_corpus_third():
    """The cover of ``mixed_100k``'s filters: equal to the reference's on
    a prefix the reference computes in seconds, and the port seeds a third
    of the corpus (33,334 filters, the federation phase's node) and
    drains it again."""
    filters, _gen = chip_smoke.build_corpus(100_000)
    head = filters[:2_500]
    assert (t_routes.IncrementalCover(head).cover
            == j_routes.IncrementalCover(head).cover)
    third = filters[0::3]
    cov = t_routes.IncrementalCover(third)
    assert "#" not in cov.cover and len(cov.cover) < len(third)
    for f in third:
        cov.remove(f)
    assert cov.cover == set() and cov.refs == {}


# -- wire codecs ------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_snapshot_codec_is_byte_equal(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        fs = {rand_filter(rng) for _ in range(int(rng.integers(0, 30)))}
        preds = ({f: [f"payload.t>{int(v)}" for v in rng.integers(0, 9, 2)]
                  for f in sorted(fs)[:3]} if rng.random() < 0.5 else None)
        epoch, seq = int(rng.integers(1, 1 << 40)), int(rng.integers(0, 99))
        wire = t_routes.encode_snapshot("n1", epoch, seq, fs, preds=preds)
        assert wire == j_routes.encode_snapshot("n1", epoch, seq, fs,
                                                preds=preds)
        assert (t_routes.decode_snapshot_preds(wire)
                == j_routes.decode_snapshot_preds(wire))
        assert t_routes.decode_snapshot(wire) == j_routes.decode_snapshot(wire)


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_delta_codec_is_byte_equal(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        add = {rand_filter(rng) for _ in range(int(rng.integers(0, 8)))}
        rem = {rand_filter(rng) for _ in range(int(rng.integers(0, 8)))}
        seq = int(rng.integers(0, 1 << 20))
        wire = t_routes.encode_delta("n2", 7, seq, add, rem)
        assert wire == j_routes.encode_delta("n2", 7, seq, add, rem)
        assert t_routes.decode_delta(wire) == j_routes.decode_delta(wire)


BAD_WIRE = [b"", b"not zlib", b"x\x9c\x03\x00", b'{"v": 2}',
            b'{"v": 1, "node": "a"}', b'{"v": 1, "node": "a", "epoch": "x",'
            b' "seq": 1, "add": [], "del": []}']


@pytest.mark.parametrize("payload", BAD_WIRE)
def test_codec_errors_equal_the_reference(payload):
    import zlib

    for decode in ("decode_snapshot", "decode_delta"):
        for raw in (payload, zlib.compress(payload)):
            outcomes = []
            for mod in (t_routes, j_routes):
                try:
                    outcomes.append(("ok", getattr(mod, decode)(raw)))
                except mod.RouteWireError as exc:
                    outcomes.append(("error", str(exc)))
            assert outcomes[0] == outcomes[1], (decode, raw)


# -- the route table ----------------------------------------------------------


def table_state(t) -> tuple:
    return (sorted((n, nr.epoch, nr.seq, sorted(nr.filters),
                    sorted(nr.preds.items())) for n, nr in t.nodes.items()),
            sorted(t.local.items()), t.remote_route_count)


@pytest.mark.parametrize("seed", SEEDS)
def test_route_table_streams_equal_the_reference(seed):
    """Seeded streams of snapshots (stale ones included), deltas (gaps
    and epoch mismatches included), flushes and local (un)subscribes:
    every return value, the held state, each peer's advertisement and
    ``nodes_for`` of sampled topics equal the reference's."""
    rng = np.random.default_rng(seed)
    port, ref = t_routes.RouteTable("me", 5), j_routes.RouteTable("me", 5)
    peers = ["p1", "p2", "p3"]
    seqs = {p: [1, 0] for p in peers}       # epoch, seq
    for _ in range(300):
        op = rng.random()
        p = peers[int(rng.integers(len(peers)))]
        if op < 0.25:
            ep, sq = seqs[p]
            if rng.random() < 0.2:
                ep += 1
            sq = sq + 1 if rng.random() < 0.9 else max(sq - 1, 0)
            seqs[p] = [ep, sq]
            fs = [rand_filter(rng) for _ in range(int(rng.integers(0, 12)))]
            preds = {f: ("payload.x>1",) for f in fs[:2]}
            args = (p, ep, sq, fs)
            assert (port.apply_snapshot(*args, preds=preds)
                    == ref.apply_snapshot(*args, preds=preds))
        elif op < 0.6:
            ep, sq = seqs[p]
            sq += 1 if rng.random() < 0.85 else 2
            if rng.random() < 0.05:
                ep += 1
            add = [rand_filter(rng) for _ in range(int(rng.integers(0, 4)))]
            rem = [rand_filter(rng) for _ in range(int(rng.integers(0, 3)))]
            ok = port.apply_delta(p, ep, sq, add, rem)
            assert ok == ref.apply_delta(p, ep, sq, add, rem)
            if ok:
                seqs[p] = [ep, sq]
        elif op < 0.65:
            assert port.flush_node(p) == ref.flush_node(p)
        elif op < 0.85:
            f = rand_filter(rng)
            assert (port.note_local_subscribe(f)
                    == ref.note_local_subscribe(f))
        else:
            keys = sorted(port.local) or [rand_filter(rng)]
            f = keys[int(rng.integers(len(keys)))]
            assert (port.note_local_unsubscribe(f)
                    == ref.note_local_unsubscribe(f))
        assert table_state(port) == table_state(ref)
        for q in peers:
            assert port.advertisement_for(q) == ref.advertisement_for(q)
        for _t in range(3):
            topic = rand_topic(rng)
            assert port.nodes_for(topic) == ref.nodes_for(topic), topic
            for q in peers:
                assert port.pred_gate(q, topic) == ref.pred_gate(q, topic)


# -- the share ledger, dedup, membership ---------------------------------------


@pytest.mark.parametrize("balance", ["pin", "weighted"])
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_share_ledger_owners_equal_the_reference(balance, seed):
    rng = np.random.default_rng(seed)
    port = t_routes.ShareLedger("n1", balance=balance)
    ref = j_routes.ShareLedger("n1", balance=balance)
    keys = [("g1", "a/+"), ("g2", "#"), ("g1", "b")]
    members = ["n1", "n2", "n3", "n4"]
    for _ in range(400):
        op = rng.random()
        key = keys[int(rng.integers(len(keys)))]
        m = members[int(rng.integers(len(members)))]
        if op < 0.5:
            n = int(rng.integers(0, 4))
            port.set_member(m, key, n)
            ref.set_member(m, key, n)
        elif op < 0.6:
            counts = {keys[int(i)]: int(rng.integers(0, 3))
                      for i in rng.integers(0, len(keys), 2)}
            port.replace_member(m, counts)
            ref.replace_member(m, counts)
        elif op < 0.65:
            port.drop_member(m)
            ref.drop_member(m)
        elif op < 0.7:
            n = int(rng.integers(0, 3))
            port.set_local(key, n)
            ref.set_local(key, n)
        for k in keys:
            token = int(rng.integers(0, 1 << 31)) if rng.random() < 0.8 \
                else None
            assert port.owner_for(k, token) == ref.owner_for(k, token)
            assert port.owns(k, token) == ref.owns(k, token)
            assert port.members_for(k) == ref.members_for(k)
        assert port.group_count == ref.group_count


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_dedup_window_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    cap = int(rng.integers(1, 40))
    port = t_manager.DedupWindow(cap=cap, epoch=3)
    ref = j_manager.DedupWindow(cap=cap, epoch=3)
    for msgid in rng.integers(0, 60, 1_000):
        assert port.admit(int(msgid)) == ref.admit(int(msgid))
    assert (port.cap, port.epoch) == (ref.cap, ref.epoch)
    assert t_manager.DEDUP_WINDOW == j_manager.DEDUP_WINDOW


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_membership_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    specs = "n1@h:1,n2@unix:/tmp/n2.sock,n3@10.0.0.3:1883"
    port = t_members.Membership(t_members.parse_peers(specs))
    ref = j_members.Membership(j_members.parse_peers(specs))
    for _ in range(200):
        node = ("n1", "n2", "n3", "zz")[int(rng.integers(4))]
        op = ("note_up", "note_alive", "note_down")[int(rng.integers(3))]
        args = (node, "err") if op == "note_down" and rng.random() < 0.5 \
            else (node,)
        getattr(port, op)(*args)
        getattr(ref, op)(*args)
        assert port.live_nodes() == ref.live_nodes()
        assert ([(n, s.connected, s.flaps, s.last_error)
                 for n, s in port.peers.items()]
                == [(n, s.connected, s.flaps, s.last_error)
                    for n, s in ref.peers.items()])
        assert (port.get(node) is None) == (ref.get(node) is None)


PEER_SPECS = ["", "nodeB@10.0.0.2:1883,nodeC@10.0.0.3:1883",
              " a@h:1 , ,b@[::1]:2", "w1@unix:/run/w1.sock,w2@h:3",
              "a@unix:", "nohost", "a@:1", "a@h", "a@h:x", "bad/id@h:1",
              "a@h:1,a@h:2", "x" * 65 + "@h:1", "a@host:1:2"]


@pytest.mark.parametrize("spec", PEER_SPECS)
def test_parse_peers_equals_the_reference(spec):
    outcomes = []
    for mod in (t_members, j_members):
        try:
            outcomes.append(("ok", [(p.node_id, p.host, p.port, p.path,
                                     p.local) for p in mod.parse_peers(spec)]))
        except mod.PeerSpecError as exc:
            outcomes.append(("error", str(exc)))
    assert outcomes[0] == outcomes[1]


@pytest.mark.parametrize("node_id", ["a", "node-1.b_c", "", "a/b", "a+b",
                                     "#", "x" * 64, "x" * 65, "ü", "a b"])
def test_valid_node_id_equals_the_reference(node_id):
    assert (t_members.valid_node_id(node_id)
            == j_members.valid_node_id(node_id))


# -- WAN shapes and partitions --------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_shape_spec_draws_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    kw = dict(delay_ms=float(rng.uniform(0, 50)),
              jitter_ms=float(rng.uniform(0, 20)),
              rate_bps=int(rng.choice([0, 64_000, 8_000_000])),
              loss=float(rng.uniform(0, 0.5)),
              burst_bytes=int(rng.integers(1, 40_000)),
              seed=int(rng.integers(0, 1 << 63)))
    port, ref = t_faults.ShapeSpec(**kw), j_faults.ShapeSpec(**kw)
    now = 0
    for _ in range(500):
        now += int(rng.integers(0, 5_000_000))
        nbytes = int(rng.integers(1, 20_000))
        assert port.depart_ns(now, nbytes) == ref.depart_ns(now, nbytes)
        assert port.lose() == ref.lose()
        assert port.rand() == ref.rand()
    assert (port.deferrals, port.losses, port.oneway_s) == \
        (ref.deferrals, ref.losses, ref.oneway_s)


@pytest.mark.parametrize("kw", [dict(delay_ms=-1), dict(jitter_ms=-1),
                                dict(rate_bps=-1), dict(loss=1.5),
                                dict(loss=-0.1)])
def test_shape_spec_refuses_what_the_reference_refuses(kw):
    for mod in (t_faults, j_faults):
        with pytest.raises(ValueError, match="bad shape"):
            mod.ShapeSpec(**kw)


@pytest.fixture
def both_registries():
    for mod in (t_faults, j_faults):
        mod.clear()
    yield
    for mod in (t_faults, j_faults):
        mod.clear()


def registry_state(mod) -> tuple:
    reg = mod.REGISTRY
    return (sorted((k, [(s.mode, s.remaining, s.delay_s, s.skip) for s in v])
                   for k, v in reg._specs.items()),
            sorted(reg._shapes), reg.any_shaped(), mod.any_armed())


@pytest.mark.parametrize("mode", ["drop", "hang", "asym"])
def test_partition_and_heal_arm_the_reference_keys(mode, both_registries):
    for mod in (t_faults, j_faults):
        mod.partition("A", "B", mode=mode, delay_s=0.2)
        mod.partition("B", "C")
    assert registry_state(t_faults) == registry_state(j_faults)
    for mod in (t_faults, j_faults):
        mod.heal("A", "B")
    assert registry_state(t_faults) == registry_state(j_faults)
    for mod in (t_faults, j_faults):
        with pytest.raises(ValueError, match="partition mode"):
            mod.partition("A", "B", mode="sideways")
    assert (t_faults.CLUSTER_LINK, t_faults.CLUSTER_ROUTE_APPLY,
            t_faults.CLUSTER_PARTITION, t_faults.CLUSTER_SHAPE) == \
        (j_faults.CLUSTER_LINK, j_faults.CLUSTER_ROUTE_APPLY,
         j_faults.CLUSTER_PARTITION, j_faults.CLUSTER_SHAPE)


@pytest.mark.parametrize("seed", [None, 7])
def test_shape_and_unshape_arm_the_reference_keys(seed, both_registries):
    specs = []
    for mod in (t_faults, j_faults):
        specs.append(mod.shape("A", "B", delay_ms=5, jitter_ms=3,
                               rate_bps=1_000_000, loss=0.2, seed=seed))
        mod.shape("B", "A", loss=0.1)
    assert registry_state(t_faults) == registry_state(j_faults)
    assert [specs[0].rand() for _ in range(20)] == \
        [specs[1].rand() for _ in range(20)]
    assert t_faults.get_shape("A->B") is specs[0]
    for mod in (t_faults, j_faults):
        mod.unshape("B", "A")
    assert registry_state(t_faults) == registry_state(j_faults)
    assert not t_faults.any_shaped()


# -- the manager's session federation -----------------------------------------


def scalars(obj) -> dict:
    return {k: v for k, v in vars(obj).items()
            if isinstance(v, (int, float, str))}


def test_manager_refuses_federated_sessions():
    """Bad identities and settings fail first, as in the reference; session
    replication (the reference's default) attaches the port's
    ``SessionFederation`` as a broker hook with the reference's settings
    (sync policy, timeouts, replica expiry, every counter), and with
    replication off the manager holds no sessions."""
    from maxmq_tpu_torch.cluster import SessionFederation

    with pytest.raises(ValueError):
        ClusterManager(Broker(BrokerOptions(device="cpu")), "has/slash", [])
    with pytest.raises(ValueError):
        ClusterManager(Broker(BrokerOptions(device="cpu")), "n1", [],
                       fwd_durability="sometimes")
    with pytest.raises(ValueError):
        ClusterManager(Broker(BrokerOptions(device="cpu")), "n1", [],
                       session_sync="sometimes")
    for kw in ({}, {"session_sync": "always", "session_sync_timeout_ms": 90,
                    "session_takeover_timeout_ms": 40,
                    "replica_expiry_s": 7.5}):
        broker = Broker(BrokerOptions(device="cpu"))
        mgr = ClusterManager(broker, "n1", [PeerSpec("n2", "h", 1)], **kw)
        jbroker = JBroker()
        ref = j_manager.ClusterManager(
            jbroker, "n1", [j_members.PeerSpec("n2", "h", 1)], **kw)
        assert isinstance(mgr.sessions, SessionFederation)
        assert mgr.sessions in broker.hooks
        assert [type(h).__name__ for h in broker.hooks] == \
            [type(h).__name__ for h in jbroker.hooks]
        assert {k: v for k, v in scalars(mgr.sessions).items()
                if k not in ("relays_held", "relays_dropped")} == \
            scalars(ref.sessions)
        assert mgr.sessions.relays_held == mgr.sessions.relays_dropped == 0
        assert scalars(mgr) == scalars(ref)
        assert mgr.fwd_coupled == ref.fwd_coupled
    mgr = ClusterManager(Broker(BrokerOptions(device="cpu")), "n1",
                         [PeerSpec("n2", "h", 1)], session_replication=False)
    ref = j_manager.ClusterManager(JBroker(), "n1",
                                   [j_members.PeerSpec("n2", "h", 1)],
                                   session_replication=False)
    assert mgr.sessions is None and not mgr.fwd_coupled
    assert scalars(mgr) == scalars(ref)
