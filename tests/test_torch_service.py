"""The port's matcher service as a whole, on the CPU: its MatcherService
with its own ServiceMatcher client, and an unchanged JAX-package broker
attached to its socket over the byte-compatible wire protocol."""

import asyncio
import os
import tempfile

import chip_smoke

from test_broker_system import connect, running_broker
from test_nfa_parity import normalize

from maxmq_tpu.matching.service import attach_matcher_service
from maxmq_tpu_torch.matching.batcher import MicroBatcher
from maxmq_tpu_torch.matching.service import (MatcherService, ServiceMatcher,
                                              decode_result, encode_result)
from maxmq_tpu_torch.matching.sig import SigEngine
from maxmq_tpu_torch.matching.trie import SubscriberSet, TopicIndex
from maxmq_tpu_torch.protocol import Subscription


def _sock_path() -> str:
    return os.path.join(tempfile.mkdtemp(prefix="maxmq-torch-svc-"), "m.sock")


def _device_engine(index):
    """The default factory's shape on the CPU, with the small-corpus
    router off so these few subscriptions still take the device path."""
    engine = SigEngine(index, device="cpu")
    engine.route_small = False
    return MicroBatcher(engine, window_us=0)


async def test_service_round_trips_sub_unsub_drop_match():
    path = _sock_path()
    svc = MatcherService(path, engine_factory=_device_engine)
    await svc.start()
    try:
        m = ServiceMatcher(path)
        await m.connect()
        want = TopicIndex()
        subs = [("c1", Subscription(filter="a/+/c", qos=1)),
                ("c2", Subscription(filter="a/#")),
                ("c3", Subscription(filter="$share/g1/a/b/c", qos=2)),
                ("c4", Subscription(filter="$share/g1/a/b/c", qos=1)),
                ("c5", Subscription(filter="a/b/c", identifier=7))]
        for cid, sub in subs:
            m.forward_subscribe(cid, sub)
            want.subscribe(cid, sub)
        topics = ("a/b/c", "a/x/c", "a", "b/c", "$SYS/a")
        for topic in topics:
            got = await m.subscribers_async(topic)
            assert normalize(got) == normalize(want.subscribers(topic)), topic
        m.forward_unsubscribe("c2", "a/#")
        got = await m.subscribers_async("a/zzz")
        assert "c2" not in got.subscriptions
        m.forward_drop("c1")
        got = await m.subscribers_async("a/x/c")
        assert "c1" not in got.subscriptions
        assert svc.matches_served >= len(topics) + 2
        await m.close()
    finally:
        await svc.close()
    # the device path served them (not only the trie)
    assert svc.matcher.engine.matches > 0


async def test_concurrent_matches_coalesce_on_one_engine():
    path = _sock_path()
    svc = MatcherService(path, engine_factory=_device_engine)
    await svc.start()
    try:
        m = ServiceMatcher(path)
        await m.connect()
        want = TopicIndex()
        for i in range(60):
            sub = Subscription(filter=f"t/{i % 7}/#" if i % 2 else f"t/+/{i}")
            m.forward_subscribe(f"c{i}", sub)
            want.subscribe(f"c{i}", sub)
        topics = [f"t/{i % 9}/{i}" for i in range(200)]
        got = await asyncio.gather(*(m.enqueue(t) for t in topics))
        for t, g in zip(topics, got):
            assert normalize(g) == normalize(want.subscribers(t)), t
        # the same topics as ONE request (the protocol's topic list)
        batch = await m.subscribers_batch_async(topics)
        assert [normalize(g) for g in batch] == [normalize(g) for g in got]
        await m.close()
    finally:
        await svc.close()
    assert svc.matcher.batches < len(topics)


def test_result_encoding_round_trip():
    s = SubscriberSet()
    s.add("c1", Subscription(filter="a/+", qos=1, identifier=3), "a/+")
    s.add_shared("g", "a/#", "c2", Subscription(filter="$share/g/a/#"))
    back = decode_result(encode_result(s))
    assert normalize(back) == normalize(s)
    assert back.subscriptions["c1"].identifiers == {"a/+": 3}


async def _drain(clients, n, timeout=10.0):
    """Payloads delivered to any of ``clients`` until ``n`` arrived."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    got = []
    while len(got) < n and loop.time() < deadline:
        for c in clients:
            while not c.messages.empty():
                got.append(c.messages.get_nowait().payload)
        await asyncio.sleep(0.02)
    await asyncio.sleep(0.1)                 # nothing delivered twice
    for c in clients:
        while not c.messages.empty():
            got.append(c.messages.get_nowait().payload)
    return got


async def test_jax_broker_attaches_to_port_service():
    """An unchanged JAX-package broker (matcher = "service" wiring) serves
    publishes through the port's service: every publish reaches the
    wildcard subscriber and one member of the shared group, as with the
    in-process trie."""
    path = _sock_path()
    svc = MatcherService(path, engine_factory=_device_engine)
    await svc.start()
    try:
        async with running_broker() as broker:
            matcher = await attach_matcher_service(broker, path)
            wild = await connect(broker, "wild-sub")
            await wild.subscribe(("svc/+/x", 1))
            shared = [await connect(broker, f"share-{i}") for i in range(2)]
            for c in shared:
                await c.subscribe(("$share/grp/svc/#", 0))
            pub = await connect(broker, "svc-pub")
            await asyncio.sleep(0.1)
            payloads = [f"m{i}".encode() for i in range(6)]
            for p in payloads:
                await pub.publish("svc/a/x", p)
            got = [await wild.next_message(timeout=10) for _ in payloads]
            assert [m.payload for m in got] == payloads
            assert all(m.topic == "svc/a/x" for m in got)
            shared_got = await _drain(shared, len(payloads))
            assert sorted(shared_got) == sorted(payloads)  # each once
            # the service's index mirrors the broker's subscriptions
            assert svc.index.subscription_count == 3
            await pub.publish("other/a/x", b"nobody")
            await asyncio.sleep(0.2)
            assert wild.messages.empty()
            for c in (wild, pub, *shared):
                await c.disconnect()
            await matcher.close()
    finally:
        await svc.close()
    assert svc.matches_served > 0


SMOKE_CPU_SIZES = {"subs": {"mixed_100k": 2_000, "hash_plus_100k": 2_000,
                            "iot_1m_share": 2_000, "cluster_100k": 2_000},
                   "check_batch": 200,
                   "service_rounds": (256, 256, 200),
                   "service_warm": 64,
                   "headline_batch": 256,
                   "headline_batches": 4,
                   "headline_warm": 2,
                   "edge_batch": 300,
                   "dense_corpus": {"n_filters": 300, "n_subs": 3_000,
                                    "width": 60},
                   "nfa_sample": 128,
                   "nfa_1m": True,
                   "cluster_batch": 256,
                   "cluster_batches": 2,
                   "decode_batch": 256,
                   "decode_sample": 128,
                   "frames": 200,
                   "pipeline": {"burst": 64,
                                "supervisor": {"deadline_ms": 1_000.0}},
                   "broker": {"corpora": ("mixed_100k", "iot_1m_share"),
                              "clients": 16, "mixed_100k": 256,
                              "iot_1m_share": 128, "faults": 279,
                              "bypass_on": ("mixed_100k", "iot_1m_share"),
                              "fleet": {"iot_1m_share": 128}},
                   "content": {"shapes": ((64, 256), (300, 64)), "reps": 2},
                   "tracing": {"bursts": 2, "service_topics": 128},
                   "started": {"corpus": "mixed_100k", "clients": 64,
                               "publishes": 256, "burst": 64,
                               "max_batch": 4_096, "device_share": 0.5,
                               "crash_publishes": 64, "crash_after": 20,
                               "boot_s": 120.0, "stop_s": 30.0}}


def test_chip_smoke_phases_rehearse_on_cpu():
    """chip_smoke.py's phases at small sizes on the CPU (kernel wrappers
    run their plain versions here): control flow, the bit-equal
    comparisons, the service answers against the trie (the signature
    service with the bypass on and off, the dense service with it off),
    the > 40-group corpus and the headline bookkeeping all run; launch
    counts apply on the card only."""
    result = chip_smoke.Smoke("cpu", sizes=SMOKE_CPU_SIZES).run()
    kernels = result["kernels"]
    assert [k["name"] for k in kernels] == ["sig_match_fixed",
                                            "dense_walk_words"]
    for kernel in kernels:
        assert kernel["bit_equal"] and kernel["max_abs_err"] == 0
        assert kernel["route"] == "cuda" and kernel["library_ms"] is None
        assert set(kernel) >= {"name", "source", "replaces", "launches",
                               "ms", "plain_ms", "bound_ms", "bound_by"}
        assert kernel["bound_by"] in ("bytes", "operations")
    assert kernels[1]["bound_ms"] > 0 and kernels[1]["walk_ms"] > 0


async def test_bulk_forwarding_is_coalesced_and_ordered():
    """Thousands of ops sent in one loop iteration reach the service in
    order as one write (asyncio's per-write buffer sum would make them
    quadratic), and a request sent after them sees all of them."""
    path = _sock_path()
    svc = MatcherService(path, engine_factory=_device_engine)
    await svc.start()
    try:
        m = ServiceMatcher(path)
        await m.connect()
        for i in range(20_000):
            m.forward_subscribe(f"c{i}", Subscription(filter=f"bulk/{i}"))
        m.forward_unsubscribe("c7", "bulk/7")
        assert len(m._out) == 20_001          # queued for one write
        got = await m.subscribers_async("bulk/7")
        assert not got.subscriptions           # the unsubscribe came last
        got = await m.subscribers_async("bulk/8")
        assert list(got.subscriptions) == ["c8"]
        assert svc.index.subscription_count == 19_999
        await m.close()
    finally:
        await svc.close()


async def test_service_socket_fault_drops_the_connection():
    """An armed SERVICE_SOCKET fault closes the client's connection: its
    in-flight request fails with ConnectionError (a broker answers it
    from its own trie) instead of hanging."""
    from maxmq_tpu_torch import faults

    path = _sock_path()
    svc = MatcherService(path, engine_factory=_device_engine)
    await svc.start()
    faults.clear()
    try:
        m = ServiceMatcher(path)
        await m.connect()
        faults.arm(faults.SERVICE_SOCKET, "drop", 1)
        fut = m.enqueue("a/b")
        try:
            await asyncio.wait_for(fut, 5)
            raise AssertionError("the request should have failed")
        except ConnectionError:
            pass
        assert faults.fired[faults.SERVICE_SOCKET] == 1
        await m.close()
    finally:
        faults.clear()
        await svc.close()
