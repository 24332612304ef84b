"""The port's ADR-011 ``SupervisedMatcher`` against the JAX package's, in
process: the same fault script through each package's supervisor over its
own ``SigEngine`` (and ``MicroBatcher``) on the CPU gives equal answers,
always equal to the trie, and equal ``fallbacks_by_reason``, breaker
trips and breaker states — for a device error, a hang past the deadline,
the open breaker, a reprobe that closes it, reprobes that fail (doubled
backoff) and a failed recompile that keeps serving. A dead matcher-service
socket under the port's supervisor is answered from the trie.

Then the whole slice: PUBLISH frames to delivery frames through each
package's broker (codec, inbound aliases, the supervised batcher over the
signature engine, the fan-out and the wire templates, as
``chip_smoke.py``'s phase 12 runs it), the port's broker against the JAX
package's and the port's trie broker: equal frames per TCP subscriber,
equal bytes per corpus client served in process, and equal match answers
for every published topic.
"""

import asyncio
import os
import tempfile
import time
from types import SimpleNamespace

import pytest

import chip_smoke
from maxmq_tpu import faults as j_faults
from maxmq_tpu.matching import batcher as j_batcher
from maxmq_tpu.matching import sig as j_sig
from maxmq_tpu.matching import supervisor as j_sup
from maxmq_tpu.matching import trie as j_trie
from maxmq_tpu.protocol import codec as j_codec
from maxmq_tpu.protocol import packets as j_packets
from maxmq_tpu.protocol import wire as j_wire
from maxmq_tpu_torch import faults as t_faults
from maxmq_tpu_torch.matching import batcher as t_batcher
from maxmq_tpu_torch.matching import sig as t_sig
from maxmq_tpu_torch.matching import supervisor as t_sup
from maxmq_tpu_torch.matching import trie as t_trie
from maxmq_tpu_torch.protocol import packets as t_packets

PKGS = {
    "jax": SimpleNamespace(
        faults=j_faults, sup=j_sup, MicroBatcher=j_batcher.MicroBatcher,
        TopicIndex=j_trie.TopicIndex, Subscription=j_packets.Subscription,
        engine=lambda idx: j_sig.SigEngine(idx, auto_refresh=False)),
    "torch": SimpleNamespace(
        faults=t_faults, sup=t_sup, MicroBatcher=t_batcher.MicroBatcher,
        TopicIndex=t_trie.TopicIndex, Subscription=t_packets.Subscription,
        engine=lambda idx: t_sig.SigEngine(idx, device="cpu",
                                           auto_refresh=False)),
}
TOPICS = ["f/1/x", "f/7/x", "f/3/zzz", "g/nope", "f/0/x"]


@pytest.fixture(autouse=True)
def clean_faults():
    for p in PKGS.values():
        p.faults.clear()
    yield
    for p in PKGS.values():
        p.faults.clear()


def small_corpus(pkg):
    idx = pkg.TopicIndex()
    for i in range(24):
        idx.subscribe(f"ex{i}", pkg.Subscription(filter=f"f/{i}/x", qos=1))
        idx.subscribe(f"pl{i}", pkg.Subscription(filter=f"f/{i}/+", qos=0))
    idx.subscribe("hash", pkg.Subscription(filter="f/#", qos=2))
    idx.subscribe("sh", pkg.Subscription(filter="$share/g/f/1/x", qos=1))
    return idx


def make_engine(pkg, idx):
    eng = pkg.engine(idx)
    eng.route_small = False      # the device path on a tiny corpus
    eng.subscribers_fixed_batch(TOPICS)      # warm outside any deadline
    return eng


def answers(idx, results, topics=TOPICS) -> list:
    """Each answer in comparable form, after checking it against the
    trie."""
    out = []
    for topic, got in zip(topics, results):
        norm = chip_smoke.normalize(got)
        assert norm == chip_smoke.normalize(idx.subscribers(topic)), topic
        out.append((topic, norm))
    return out


def state(sup) -> dict:
    return {"by_reason": dict(sup.fallbacks_by_reason),
            "trips": sup.breaker_trips,
            "recoveries": sup.breaker_recoveries,
            "state": sup.breaker_state_name,
            "refresh_failures": sup.refresh_failures}


# -- the fault script, one case at a time --------------------------------

def case_raise(pkg):
    idx = small_corpus(pkg)
    sup = pkg.sup.SupervisedMatcher(make_engine(pkg, idx), deadline_ms=0,
                                    breaker_threshold=100)
    rec = [answers(idx, sup.subscribers_batch(TOPICS)), state(sup)]
    pkg.faults.arm(pkg.faults.DEVICE_MATCH, "raise", count=-1)
    rec += [answers(idx, sup.subscribers_batch(TOPICS)), state(sup)]
    pkg.faults.clear()
    rec += [answers(idx, sup.subscribers_batch(TOPICS)), state(sup)]
    assert rec[3]["by_reason"]["error"] == len(TOPICS)
    assert rec[5]["by_reason"]["error"] == len(TOPICS)
    assert rec[5]["state"] == "closed"
    return rec


async def case_hang(pkg):
    """A device call hanging past the deadline through the async batcher
    surface: answered by the deadline from the trie."""
    idx = small_corpus(pkg)
    batcher = pkg.MicroBatcher(make_engine(pkg, idx), window_us=0,
                               cpu_bypass=False)
    sup = pkg.sup.SupervisedMatcher(batcher, deadline_ms=100,
                                    breaker_threshold=100)
    rec = [answers(idx, [await sup.enqueue("f/1/x")], ["f/1/x"])]
    pkg.faults.arm(pkg.faults.DEVICE_MATCH, "hang", count=-1, delay_s=0.5)
    t0 = time.perf_counter()
    got = await sup.enqueue("f/7/x")
    took = time.perf_counter() - t0
    rec += [answers(idx, [got], ["f/7/x"]), state(sup)]
    pkg.faults.clear()
    await asyncio.sleep(0.6)               # the hung call drains
    await batcher.close()
    assert took < 0.45, took
    assert rec[2]["by_reason"]["deadline"] == 1
    return rec


def _tripped(pkg, threshold=3):
    idx = small_corpus(pkg)
    sup = pkg.sup.SupervisedMatcher(make_engine(pkg, idx), deadline_ms=0,
                                    breaker_threshold=threshold,
                                    breaker_window_s=10.0,
                                    backoff_initial_s=0.15,
                                    backoff_max_s=0.6)
    pkg.faults.arm(pkg.faults.DEVICE_MATCH, "raise", count=-1)
    rec = [answers(idx, sup.subscribers_batch(TOPICS))
           for _ in range(threshold)]
    rec.append(state(sup))
    assert rec[-1]["state"] == "open" and rec[-1]["trips"] == 1
    return idx, sup, rec


def case_breaker_open(pkg):
    """Open: answered from the trie with no device call."""
    idx, sup, rec = _tripped(pkg)
    fired = pkg.faults.fired.get(pkg.faults.DEVICE_MATCH, 0)
    rec += [answers(idx, sup.subscribers_batch(TOPICS)), state(sup),
            pkg.faults.fired.get(pkg.faults.DEVICE_MATCH, 0) - fired]
    assert rec[-1] == 0
    assert rec[-2]["by_reason"]["breaker_open"] == len(TOPICS)
    return rec


def case_reprobe_closes(pkg):
    idx, sup, rec = _tripped(pkg)
    pkg.faults.clear()
    time.sleep(0.2)                       # past the 0.15 s backoff
    rec += [answers(idx, sup.subscribers_batch(TOPICS)), state(sup)]
    assert rec[-1]["state"] == "closed" and rec[-1]["recoveries"] == 1
    assert sup.degraded_seconds > 0.15
    return rec


def case_reprobe_fails(pkg):
    """A failed reprobe re-opens with the backoff doubled, to its cap."""
    idx, sup, rec = _tripped(pkg)
    for wait in (0.2, 0.35, 0.65):
        time.sleep(wait)
        rec += [answers(idx, sup.subscribers_batch(TOPICS)), state(sup),
                sup._backoff]
    assert [rec[i] for i in (6, 9, 12)] == pytest.approx([0.3, 0.6, 0.6])
    assert rec[-2]["state"] == "open" and rec[-2]["trips"] == 1
    return rec


def case_refresh(pkg):
    """A failed recompile keeps the last-good tables serving, counts
    toward the breaker, and the journal overlay keeps answers exact."""
    idx = small_corpus(pkg)
    eng = make_engine(pkg, idx)
    sup = pkg.sup.SupervisedMatcher(eng, deadline_ms=0,
                                    breaker_threshold=100)
    v0 = eng.tables.version
    idx.subscribe("late", pkg.Subscription(filter="f/9/late", qos=0))
    pkg.faults.arm(pkg.faults.DEVICE_RECOMPILE, "raise", count=2)
    rec = [sup.refresh(force=True), sup.refresh(force=True), state(sup),
           eng.tables.version == v0]
    topics = TOPICS + ["f/9/late"]
    rec.append(answers(idx, sup.subscribers_batch(topics), topics))
    rec += [sup.refresh(force=True), eng.tables.version > v0]
    assert rec[:2] == [False, False] and rec[2]["refresh_failures"] == 2
    assert rec[3] and rec[-2] is True and rec[-1]
    return rec


CASES = {"raise": case_raise, "hang": case_hang,
         "breaker_open": case_breaker_open,
         "reprobe_closes": case_reprobe_closes,
         "reprobe_fails": case_reprobe_fails, "refresh": case_refresh}


@pytest.mark.parametrize("case", list(CASES))
async def test_fault_script_parity(case):
    """The same rung, scripted through both packages' supervisors: equal
    answers (each equal to the trie), counters and breaker states."""
    got = {}
    for name, pkg in PKGS.items():
        fn = CASES[case]
        rec = fn(pkg)
        got[name] = await rec if asyncio.iscoroutine(rec) else rec
    assert got["torch"] == got["jax"]


async def test_dead_service_socket_answered_from_trie():
    """The port's supervisor over its ``ServiceMatcher``: with the service
    gone, the pending match and the next one are answered from the trie
    (reason "error", never "overflow")."""
    from maxmq_tpu_torch.matching.service import (MatcherService,
                                                  ServiceMatcher)

    pkg = PKGS["torch"]

    def factory(index):
        return pkg.MicroBatcher(make_engine(pkg, index), window_us=0,
                                cpu_bypass=False)

    path = os.path.join(tempfile.mkdtemp(prefix="maxmq-torch-sup-"),
                        "m.sock")
    idx = small_corpus(pkg)
    svc = MatcherService(path, engine_factory=factory)
    await svc.start()
    m = ServiceMatcher(path)
    try:
        await m.connect()
        for cid, sub in ((c, s) for f, c, s, g in idx.all_subscriptions()):
            m.forward_subscribe(cid, sub)
        sup = pkg.sup.SupervisedMatcher(m, index=idx, deadline_ms=10_000,
                                        breaker_threshold=100)
        answers(idx, [await sup.enqueue("f/1/x")], ["f/1/x"])
        assert sup.fallbacks_by_reason["error"] == 0
        await svc.close()
        await asyncio.sleep(0.05)
        for topic in ("f/7/x", "f/3/zzz"):
            answers(idx, [await sup.enqueue(topic)], [topic])
        by = sup.fallbacks_by_reason
        assert by["error"] >= 1 and by["overflow"] == 0
        assert sup.fallbacks == by["error"] + by["deadline"] \
            + by["breaker_open"]
    finally:
        await m.close()
        await svc.close()


# -- the whole slice: frames in, frames out --------------------------------

def jax_kit():
    return SimpleNamespace(
        Packet=j_packets.Packet, FixedHeader=j_codec.FixedHeader,
        PT=j_codec.PacketType, Subscription=j_packets.Subscription,
        parse_stream=j_packets.parse_stream, write_varint=j_codec.write_varint,
        wire=j_wire, TopicAliases=j_trie.TopicAliases,
        TopicIndex=j_trie.TopicIndex)


def jax_broker_kit():
    from maxmq_tpu import bootstrap
    from maxmq_tpu.broker import Broker, BrokerOptions, Client, TCPListener
    from maxmq_tpu.hooks import AllowHook
    from maxmq_tpu.utils.config import Config

    return SimpleNamespace(
        Broker=Broker, BrokerOptions=BrokerOptions, TCPListener=TCPListener,
        Client=Client, AllowHook=AllowHook, Config=Config,
        capabilities_from_config=bootstrap.capabilities_from_config,
        build_matcher=bootstrap.build_matcher)


# the production supervisor with a wider deadline: on a CPU shared with
# other test workers a 250 ms wall-clock deadline would make which answers
# the trie serves depend on load (the fault-script tests above and the
# card run hold the deadline itself)
SLICE_DEADLINE_MS = 5_000


async def run_slice(bk, pkg_kit, matcher, preload, plan, traffic, fleet,
                    versions, device=None):
    """PUBLISH frames through one package's broker (``build_matcher`` at
    the production settings, or its trie), the subscribers of ``plan``
    connected over TCP and the corpus clients of ``fleet`` served live in
    process (a CONNECT built with ``pkg_kit``, the broker's package, at
    ``versions``); returns each subscriber's frames and each fleet
    session's bytes, the match answer of every published topic, by topic
    and normalized (the answers the broker dispatched; the trie broker's
    are its index's), and the matcher."""
    conf = chip_smoke.broker_config(bk, matcher)
    conf.matcher_deadline_ms = SLICE_DEADLINE_MS
    kit = chip_smoke.port_kit()
    side = await chip_smoke.start_broker(bk, conf, preload,
                                         matcher != "trie", device)
    b = side.broker
    answers, dispatch = [], b._dispatch_match

    def recorded(topic):
        answers.append((topic, dispatch(topic)))
        return answers[-1][1]

    b._dispatch_match = recorded
    try:
        await chip_smoke.connect_subscribers(kit, side, plan)
        chip_smoke.connect_fleet(bk, pkg_kit, side, fleet, versions)
        engine = getattr(b.matcher, "engine", None)
        if engine is not None:                 # the clients' subscriptions
            await asyncio.get_running_loop().run_in_executor(
                None, chip_smoke.catch_up, engine)
        for frames in traffic:
            await side.bursts(kit, frames)
        streams = side.streams()
        streams.update(side.fleet_streams({}))
        streams.update(await chip_smoke.resume_offline(side, plan))
        if b.matcher is None:
            answers = [(pk.topic, b.topics.subscribers(pk.topic))
                       for frames in traffic
                       for pk in chip_smoke.PubDecoder(kit).decode(*frames)]
        else:
            answers = [(t, f.result()) for t, f in answers
                       if t != chip_smoke.FENCE_TOPIC]
        return (streams, {t: chip_smoke.normalize(r) for t, r in answers},
                b.matcher)
    finally:
        del b._dispatch_match
        await side.close()


async def test_publish_frames_to_delivery_frames_parity():
    """Both packages' brokers over the same PUBLISH frames (v5 and
    v3.1.1, QoS 0-2, inbound aliases, retained publishes; subscribers over
    TCP with identifiers, retain-as-published, outbound aliases, '$share'
    groups, persistent sessions resumed after the traffic; the 2,000-filter
    corpus's online clients as live sessions), each with
    ``build_matcher``'s supervised signature stack (the port's on the
    CPU), and the port's trie broker: every subscriber and corpus client
    receives the same bytes in the same order, every published topic gets
    the same match answer, and no answer comes from a supervisor's
    hedge."""
    filters, gen = chip_smoke.build_corpus(2_000, seed=42, share_frac=0.1)
    clients = chip_smoke.ClientTable(len(filters))
    traffic, published = [], set()
    for n, seed in ((512, 42), (16, 43)):
        topics = gen(n, seed2=4000 + seed)
        published.update(topics)
        t_frames = chip_smoke.publish_frames(chip_smoke.port_kit(), topics,
                                             seed)
        assert chip_smoke.publish_frames(jax_kit(), topics, seed) \
            == t_frames                    # the two encoders agree
        traffic.append(t_frames)
    versions = {f"cl-{i}": (5 if clients.v5[i] else 4,
                            int(clients.alias_max[i]))
                for i in range(len(filters))}
    got, matched = {}, {}
    for name, bk, kit, matcher, device in (
            ("torch", chip_smoke.broker_kit(), chip_smoke.port_kit(), "sig",
             "cpu"),
            ("jax", jax_broker_kit(), jax_kit(), "sig", None),
            ("torch trie", chip_smoke.broker_kit(), chip_smoke.port_kit(),
             "trie", None)):
        preload = [(f"cl-{i}", clients.subscription(kit, i, f))
                   for i, f in enumerate(filters)]
        # every online corpus client live in process: its deliveries are
        # compared too (the offline ones have no session to deliver to)
        fleet = [(cid, [sub]) for i, (cid, sub) in enumerate(preload)
                 if not clients.offline[i]]
        index = kit.TopicIndex()
        for cid, sub in preload:
            index.subscribe(cid, sub)
        plan = chip_smoke.subscriber_plan(
            chip_smoke.port_kit(), 24, gen(512, seed2=4042),
            index.subscribers)
        streams, answers, sup = await run_slice(
            bk, kit, matcher, preload, plan, traffic, fleet, versions,
            device)
        if sup is not None:
            hedged = {k: v for k, v in sup.fallbacks_by_reason.items()
                      if k != "overflow" and v}
            assert not hedged and not sup.breaker_trips, (name, hedged)
        got[name], matched[name] = streams, answers
        fleet_bytes = sum(len(streams[cid]) for cid, _s in fleet)
        delivered = sum(len(v) for c, v in streams.items()
                        if not c.startswith("cl-"))
        assert delivered > 1_000 and fleet_bytes > 10_000, (
            name, delivered, fleet_bytes)
    assert set(matched["torch trie"]) == published   # every topic
    assert matched["torch"] == matched["jax"] == matched["torch trie"]
    assert got["torch"] == got["jax"] == got["torch trie"]
