"""Federations of the port's brokers held against the JAX package's on the
CPU, in process over local TCP, from numpy seeds:

- a three-node line A - B - C (``chip_smoke.FED_LINE``) as a JAX federation
  and as a port federation, every node on its trie: each subscriber's
  PUBLISH frames equal, in order, packet ids included, and each node's
  forward counters and retained set equal;
- the port's line with ``sig`` on ``device="cpu"`` against the port's trie
  line;
- a mixed pair: one port node peered with one JAX-package node (either
  way round) against an all-JAX pair. The brokers share no object, only
  bytes on the socket, so this holds the ``$cluster/*`` wire compatible:
  routes and forwards go both ways, and so do the federated sessions'
  replication and a live takeover.
Every run has its federated sessions at the default configuration and,
after its traffic, a live session takeover (``takeover``) with more
traffic after it.

Each run is ``chip_smoke.fed_in_process``: the subscribers are
``subscriber_plan``'s raw TCP clients spread over the nodes (no '#' probe,
so the route covers are not one '#'), each node also holding a corpus
slice; the traffic is ``publish_frames`` in fenced bursts from two nodes,
once the line has converged (every node holding the routes ``fed_routes``
computes from the subscriptions).
"""

import pytest

from chip_smoke import FED_LINE, broker_kit, streams_equal
from chip_smoke import fed_in_process as run_federation
from maxmq_tpu import cluster as j_cluster
from maxmq_tpu_torch import cluster as t_cluster
from test_torch_supervisor import jax_broker_kit

PAIR = {"A": ("B",), "B": ("A",)}
JAX = (jax_broker_kit(), j_cluster, None, None)
TRIE = (broker_kit(), t_cluster, None, None)
SIG = (broker_kit(), t_cluster, "sig", "cpu")


def assert_same(got: dict, want: dict, what: str) -> None:
    n = streams_equal(what, got["frames"], want["frames"])
    assert n > 100, n
    assert got["forwards"] == want["forwards"]
    assert got["retained"] == want["retained"]
    assert got["expected_routes"] == want["expected_routes"]


@pytest.mark.parametrize("seed", [11, 12])
async def test_line_port_equals_jax_on_tries(seed):
    want = await run_federation(FED_LINE, dict.fromkeys(FED_LINE, JAX), seed,
                                ("A", "C"), takeover=("B", "C", 4))
    got = await run_federation(FED_LINE, dict.fromkeys(FED_LINE, TRIE), seed,
                               ("A", "C"), takeover=("B", "C", 4))
    assert_same(got, want, "port line vs JAX line")
    # four of B's subscribers taken over live at C: the same session
    # counters as the JAX line's, the taken-over clients' frames at both
    # nodes equal (in ``frames``)
    assert got["takeover"]["sessions"] == want["takeover"]["sessions"]
    assert got["takeover"]["sessions"]["C"]["takeovers"] == 4
    assert sum(1 for c in got["frames"] if c.endswith("@B")) == 4
    # C's publishes reached A over two hops through B, which relayed them
    assert got["forwards"]["B"]["forwards_sent"] > 0
    assert got["forwards"]["A"]["forwards_delivered"] > 0


test_line_port_equals_jax_on_tries._async_timeout = 150


@pytest.mark.parametrize("seed", [21])
async def test_line_sig_on_cpu_equals_trie(seed):
    want = await run_federation(FED_LINE, dict.fromkeys(FED_LINE, TRIE), seed,
                                ("A", "C"), takeover=("B", "C", 4))
    got = await run_federation(FED_LINE, dict.fromkeys(FED_LINE, SIG), seed,
                               ("A", "C"), takeover=("B", "C", 4))
    assert_same(got, want, "port sig line vs port trie line")
    assert got["takeover"]["matchers"]["C"]["batches"] > 0
    # the host bypass is off: the engine answered every node's batches,
    # B's forwarded publishes included
    for node in FED_LINE:
        counts = got["matchers"][node]
        assert counts["batches"] > 0 and not counts["bypassed_topics"], node


test_line_sig_on_cpu_equals_trie._async_timeout = 180


@pytest.mark.parametrize("port_node", ["A", "B"])
async def test_mixed_pair_equals_a_jax_pair(port_node):
    """One port node and one JAX node over TCP: routes and forwards go
    both ways, and the frames equal an all-JAX pair's."""
    want = await run_federation(PAIR, dict.fromkeys(PAIR, JAX), 31,
                                ("A", "B"), takeover=("A", "B", 3))
    specs = dict.fromkeys(PAIR, JAX)
    specs[port_node] = TRIE
    got = await run_federation(PAIR, specs, 31, ("A", "B"),
                               takeover=("A", "B", 3))
    assert_same(got, want, f"mixed pair (port {port_node}) vs JAX pair")
    # A's subscribers taken over live at B across the two packages: the
    # claim, the state pull and the install go over the session wire
    assert got["takeover"]["sessions"] == want["takeover"]["sessions"]
    assert got["takeover"]["sessions"]["B"]["takeovers"] == 3
    for node in PAIR:
        assert got["forwards"][node]["forwards_sent"] > 0
        assert got["forwards"][node]["forwards_delivered"] > 0


test_mixed_pair_equals_a_jax_pair._async_timeout = 150
