"""The JAX package's cluster scenarios run on the port, loaded with the
port's package in place of the JAX package's (``port_module``), with
federated sessions off (``session_replication=False``: they come with the
next port slice):

- ``tests/test_cluster.py``: all 21 (route propagation and aggregation,
  two-hop exactly-once, loop prevention on a cycle, link flaps, the
  stale-epoch flush, retained state, the QoS 1 ack rollback, route-apply
  faults, epoch-scoped dedup, the reserved namespace, metrics and $SYS,
  the bootstrap from a config, the MQTT client's errors);
- ``tests/test_cluster_trace.py``: every scenario without a takeover (the
  cross-node trace, pre-017 peers, the envelope flags, clock skew, the
  telemetry plane and ``/cluster/metrics``, the QoS 2 release span, the
  journal buckets, the $SYS health subtree, the scripts' gates);
- ``tests/test_partition.py``: every scenario without wills, takeovers,
  replica expiry or the session ledger (the partition helpers, the
  share-ledger rotation, split-brain with no PUBACKed loss, never-wedges,
  asymmetric loss and flapping, parking in a dead read loop,
  ``fwd_durability`` off, a restored offline session, parked forwards
  across a restart, the chained relay kill, sub-keepalive blips, the
  hop-capped relay and the route-sync hold).

Where a scenario's own assertions read the session federation, the
literal replacement says so: the split-brain scenario's replica digests
(sessions) are not awaited, and the $SYS health subtree has no
``sess_lag`` entry without sessions, as the JAX package's has none with
replication off. ``test_partition.py`` runs its nodes at
``session_sync="always"``, under which the reference's default
``fwd_durability="coupled"`` couples the publisher's ack to the forwards;
without sessions the port gets the same coupling from
``fwd_durability="always"``.
"""

import pytest

from maxmq_tpu_torch import faults as port_faults
from test_torch_broker_engine import port_module, run_scenario, scenario_cases

CLUSTER = port_module(
    "test_cluster.py", "torch_port_cluster",
    replace=(('    kw.setdefault("keepalive", 0.5)\n',
              '    kw.setdefault("keepalive", 0.5); '
              'kw.setdefault("session_replication", False)\n'),
             ('                  metrics_enabled=False, matcher="")\n'
              '    broker = build_broker(',
              '                  metrics_enabled=False, matcher="", '
              'cluster_session_replication=False)\n'
              '    broker = build_broker(')))
TRACE = port_module(
    "test_cluster_trace.py", "torch_port_cluster_trace",
    replace=(('    kw.setdefault("keepalive", 0.5)\n',
              '    kw.setdefault("keepalive", 0.5); '
              'kw.setdefault("session_replication", False)\n'),
             ('        assert f"{base}/sess_lag" in entries\n',
              '        assert f"{base}/sess_lag" not in entries   '
              '# no sessions\n')))
PARTITION = port_module(
    "test_partition.py", "torch_port_partition",
    replace=(('    kw.setdefault("keepalive", 0.25)\n',
              '    kw.setdefault("keepalive", 0.25); '
              'kw.setdefault("session_replication", False); '
              'kw.setdefault("fwd_durability", "always")\n'),
             ('        await wait_for(digests_match, what="replica digests '
              'converged")\n',
              '        pass    # replica digests: no sessions\n')))

CLUSTER_CASES = scenario_cases(CLUSTER, 1, 10_000)
TRACE_CASES = scenario_cases(
    TRACE, 1, 10_000, skip=("test_takeover_trace_and_sess_ship_report",))
PARTITION_CASES = scenario_cases(
    PARTITION, 1, 10_000,
    skip=("test_will_fires_exactly_once_on_owner_death",
          "test_reconnect_cancels_pending_will",
          "test_parked_will_delay_survives_owner_death",
          "test_owner_local_delayed_will_fire_stands_replicas_down",
          "test_takeover_cancels_parked_will_delay",
          "test_scripted_clock_will_countdown_resume",
          "test_replica_expiry_purges_dead_owners_sessions",
          "test_replica_expiry_returning_owner_wins",
          "test_pubrec_pending_streams_to_replicas",
          "test_held_inflight_replicates_and_survives_takeover",
          "test_relay_restart_mid_stream_converges",
          "test_weighted_share_exactly_once_and_balanced",
          "test_scripted_clock_will_wall_deadline_cold_entry"))


def test_every_sessionless_scenario_is_ported():
    assert len(CLUSTER_CASES) == 21
    assert len(TRACE_CASES) == 12
    assert len(PARTITION_CASES) == 13


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
