"""The port's broker leaf modules (``maxmq_tpu_torch.broker``: inflight
tracking, the overload ladder's state and ranking, the $SYS counters)
against the JAX package's on the same scripted inputs."""

import dataclasses
import random
from types import SimpleNamespace

import pytest

from maxmq_tpu.broker import inflight as ref_inflight
from maxmq_tpu.broker import overload as ref_overload
from maxmq_tpu.broker import sys_info as ref_sys_info
from maxmq_tpu.protocol import packets as ref_packets
from maxmq_tpu_torch.broker import inflight, overload, sys_info
from maxmq_tpu_torch.protocol import packets


def inflight_script(mod, pkt_mod, seed: int, recv: int, send: int):
    rng = random.Random(seed)
    inf = mod.Inflight(receive_maximum=recv, send_maximum=send)
    seen = []
    for step in range(400):
        pid = rng.randint(1, 40)
        r = rng.random()
        if r < 0.3:
            pkt = pkt_mod.Packet(packet_id=pid, topic=f"t/{pid}",
                                 payload=bytes([step % 256]),
                                 created=rng.choice((1.0, 2.0, 3.0)))
            seen.append(("set", inf.set(pkt)))
        elif r < 0.4:
            seen.append(("del", inf.delete(pid)))
        elif r < 0.5:
            inf.note_stored(pid)
            seen.append(("stored", inf.stored(pid)))
        elif r < 0.6:
            p = inf.get(pid)
            seen.append(("get", None if p is None else
                         (p.packet_id, p.topic, p.payload)))
        elif r < 0.7:
            seen.append(("recv", inf.take_receive_quota(),
                         inf.receive_quota))
        elif r < 0.75:
            inf.return_receive_quota()
            seen.append(("rret", inf.receive_quota))
        elif r < 0.85:
            seen.append(("send", inf.take_send_quota(), inf.send_quota))
        elif r < 0.9:
            inf.return_send_quota()
            seen.append(("sret", inf.send_quota))
        elif r < 0.95:
            seen.append(("all", [(p.packet_id, p.created)
                                 for p in inf.all()]))
        else:
            clone = inf.clone()
            seen.append(("clone", len(clone), clone.digest(),
                         sorted(clone._stored),
                         clone.receive_quota == clone.maximum_receive))
        seen.append(("len", len(inf), inf.digest()))
    return seen


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("recv,send", [(0, 0), (3, 5), (1, 0)])
def test_inflight_equal(seed, recv, send):
    assert inflight_script(inflight, packets, seed, recv, send) == \
        inflight_script(ref_inflight, ref_packets, seed, recv, send)


class Clock:
    def __init__(self) -> None:
        self.now = 50.0

    def monotonic(self) -> float:
        return self.now


def bucket_script(mod, monkeypatch, rate, burst, seed):
    clock = Clock()
    monkeypatch.setattr(mod, "time", clock)
    rng = random.Random(seed)
    tb = mod.TokenBucket(rate, burst)
    out = [(tb.rate, tb.burst, tb.tokens)]
    for _ in range(300):
        clock.now += rng.choice((0.0, 0.001, 0.05, 0.3, 2.0))
        explicit = rng.random() < 0.3
        ok = tb.allow(clock.now + 0.01 if explicit else None)
        out.append((ok, round(tb.tokens, 12)))
    return out


@pytest.mark.parametrize("rate,burst", [(0.0, 0), (5.0, 0), (0.5, 0),
                                        (10.0, 3), (100.0, 1)])
@pytest.mark.parametrize("seed", range(2))
def test_token_bucket_under_a_scripted_clock(monkeypatch, rate, burst,
                                             seed):
    got = bucket_script(overload, monkeypatch, rate, burst, seed)
    want = bucket_script(ref_overload, monkeypatch, rate, burst, seed)
    assert got == want
    if rate > 0:
        assert not all(ok for ok, _t in got[1:])


def overload_script(mod, caps, seed):
    rng = random.Random(seed)
    st = mod.OverloadState(caps)
    out = []
    queued = []
    for step in range(600):
        # phases of filling and draining cross both watermarks
        if queued and rng.random() < (0.8 if step // 150 % 2 else 0.2):
            size = queued.pop(rng.randrange(len(queued)))
            st.note_get(size)
        else:
            size = rng.randint(1, 4096)
            queued.append(size)
            st.note_put(size)
        out.append((st.queued_bytes, st.shedding, st.sheds, st.recoveries,
                    st.below_low_water()))
    fields = {k: v for k, v in vars(st).items() if k != "caps"}
    return out, fields


@pytest.mark.parametrize("budget,high,low", [(0, 0.8, 0.5),
                                             (64 << 10, 0.8, 0.5),
                                             (150_000, 0.9, 0.2)])
@pytest.mark.parametrize("seed", range(2))
def test_overload_state_equal(budget, high, low, seed):
    caps = SimpleNamespace(broker_byte_budget=budget,
                           overload_high_water=high, overload_low_water=low)
    got = overload_script(overload, caps, seed)
    want = overload_script(ref_overload, caps, seed)
    assert got == want
    if budget:
        assert got[1]["sheds"] > 0 and got[1]["recoveries"] > 0


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("n", [0, 3, 8, 20])
def test_top_offenders_equal(seed, n):
    rng = random.Random(seed)
    clients = []
    for i in range(25):
        by = {r: rng.randint(0, 30) for r in
              rng.sample(["shed", "global_budget", "queue", "stall"], 2)}
        clients.append(SimpleNamespace(
            id=f"c{i:02d}", dropped_msgs=sum(by.values()) + rng.randint(0, 5),
            dropped_bytes=rng.randint(0, 9999), drops_by_reason=by))
    got = overload.top_offenders(clients, n)
    assert got == ref_overload.top_offenders(clients, n)
    assert len(got) <= n
    assert overload.top_offenders(clients) == \
        ref_overload.top_offenders(clients)
    assert overload.TOP_OFFENDERS == ref_overload.TOP_OFFENDERS


def test_sys_info_equal():
    got, want = sys_info.SysInfo(), ref_sys_info.SysInfo()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    for s in (got, want):
        s.version, s.bytes_sent, s.clients_connected = "v", 99, 4
        s.extra["k"] = [1]
    a, b = got.clone(), want.clone()
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    a.extra["k2"] = 1
    assert "k2" not in got.extra
