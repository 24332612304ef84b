"""The JAX package's cluster scenarios run on the port, loaded with the
port's package in place of the JAX package's (``port_module``), with the
reference's own assertions and its own settings (federated sessions on,
as the reference's harnesses run them):

- ``tests/test_cluster.py``: all 21 (route propagation and aggregation,
  two-hop exactly-once, loop prevention on a cycle, link flaps, the
  stale-epoch flush, retained state, the QoS 1 ack rollback, route-apply
  faults, epoch-scoped dedup, the reserved namespace, metrics and $SYS,
  the bootstrap from a config, the MQTT client's errors);
- ``tests/test_cluster_trace.py``: all 13 (the cross-node trace, pre-017
  peers, the envelope flags, clock skew, the telemetry plane and
  ``/cluster/metrics``, the takeover trace with its ship-leg report, the
  QoS 2 release span, the journal buckets, the $SYS health subtree, the
  scripts' gates);
- ``tests/test_partition.py``: all 26, at the reference's
  ``session_sync="always"`` (the partition helpers, the share-ledger
  rotation, split-brain with no PUBACKed loss once the replica digests
  converge, never-wedges, asymmetric loss and flapping, parking in a dead
  read loop, ``fwd_durability`` off, wills fired once on an owner's
  death, cancelled, parked and resumed on scripted clocks, replica
  expiry, streamed PUBREC-pending and held inflight through a takeover,
  the relay restart, the weighted ``$share``, a restored offline session,
  parked forwards across a restart, the chained relay kill, sub-keepalive
  blips, the hop-capped relay and the route-sync hold).
"""

import pytest

from maxmq_tpu_torch import faults as port_faults
from test_torch_broker_engine import port_module, run_scenario, scenario_cases

CLUSTER = port_module("test_cluster.py", "torch_port_cluster")
TRACE = port_module("test_cluster_trace.py", "torch_port_cluster_trace")
PARTITION = port_module("test_partition.py", "torch_port_partition")

CLUSTER_CASES = scenario_cases(CLUSTER, 1, 10_000)
TRACE_CASES = scenario_cases(TRACE, 1, 10_000)
PARTITION_CASES = scenario_cases(PARTITION, 1, 10_000)


def test_every_sessionless_scenario_is_ported():
    assert len(CLUSTER_CASES) == 21
    assert len(TRACE_CASES) == 13
    assert len(PARTITION_CASES) == 26


@pytest.fixture
def clean_port_faults():
    port_faults.clear()
    yield
    port_faults.clear()
    port_faults.REGISTRY.reset_clock()


@pytest.mark.parametrize("name,kwargs", CLUSTER_CASES,
                         ids=[n for n, _k in CLUSTER_CASES])
async def test_cluster_scenario_on_the_port(name, kwargs, tmp_path,
                                            clean_port_faults):
    await run_scenario(getattr(CLUSTER, name), kwargs, tmp_path)


test_cluster_scenario_on_the_port._async_timeout = 60


@pytest.mark.parametrize("name,kwargs", TRACE_CASES,
                         ids=[n for n, _k in TRACE_CASES])
async def test_cluster_trace_scenario_on_the_port(name, kwargs, tmp_path,
                                                  clean_port_faults):
    await run_scenario(getattr(TRACE, name), kwargs, tmp_path)


test_cluster_trace_scenario_on_the_port._async_timeout = 60


@pytest.mark.parametrize("name,kwargs", PARTITION_CASES,
                         ids=[n for n, _k in PARTITION_CASES])
async def test_partition_scenario_on_the_port(name, kwargs, tmp_path,
                                              clean_port_faults):
    await run_scenario(getattr(PARTITION, name), kwargs, tmp_path)


test_partition_scenario_on_the_port._async_timeout = 90
