"""The port's host utilities (``maxmq_tpu_torch.utils``: config, logger,
snowflake, build info) against the JAX package's on the same inputs."""

import dataclasses
import io
import json
import time

import pytest

from maxmq_tpu.utils import build as ref_build
from maxmq_tpu.utils import config as ref_config
from maxmq_tpu.utils import logger as ref_logger
from maxmq_tpu.utils import snowflake as ref_snowflake
from maxmq_tpu_torch.utils import build, config, logger, snowflake

CONF_TEXT = """
log_format = "json"
log_level = "debug"
machine_id = 17
metrics_address = "127.0.0.1:9999"
metrics_profiling = true
mqtt_max_qos = 1
mqtt_max_session_expiry_interval = 300
mqtt_max_outbound_messages = 77
mqtt_subscription_identifier_available = false
mqtt_sys_topic_update_interval = 9
broker_overload_high_water = 0.9
cluster_link_keepalive = 2
filter_backend = "{backend}"
filter_max_subscriptions = 12
matcher = "nfa"
matcher_deadline_ms = "125"
unknown_key = "ignored"
"""

ENVS = [
    {},
    {"MAXMQ_LOG_LEVEL": "warn", "MAXMQ_MQTT_MAX_QOS": "2",
     "MAXMQ_METRICS_ENABLED": "off", "MAXMQ_TRACE_SAMPLE_N": "4",
     "MAXMQ_CONNECT_RATE": "2.5"},
    {"MAXMQ_MQTT_SYS_TOPIC_UPDATE_INTERVAL": "3",
     "MAXMQ_MQTT_MAX_OUTBOUND_MESSAGES": "5",
     "MAXMQ_MQTT_MAX_OUTBOUND_QUEUE": "6"},
    {"MAXMQ_FILTER_BACKEND": "jnp"},
]


def test_config_defaults_equal():
    got, want = config.config_as_dict(config.Config()), \
        ref_config.config_as_dict(ref_config.Config())
    assert got == want
    assert got["filter_backend"] == "numpy"
    assert [f.name for f in dataclasses.fields(config.Config)] == \
        [f.name for f in dataclasses.fields(ref_config.Config)]
    assert config.CONFIG_SEARCH_PATHS == ref_config.CONFIG_SEARCH_PATHS
    assert config._REFERENCE_ALIASES == ref_config._REFERENCE_ALIASES


@pytest.mark.parametrize("env", ENVS, ids=range(len(ENVS)))
@pytest.mark.parametrize("backend", ["numpy", "auto", "jnp"])
def test_load_config_same_toml(tmp_path, env, backend):
    """The same TOML text and environment load to the same config, but the
    content plane's device backend: the JAX package's ``jnp`` reads as
    the port's ``torch``."""
    path = tmp_path / "maxmq.conf"
    path.write_text(CONF_TEXT.format(backend=backend))
    got = config.config_as_dict(config.load_config(str(path), env=env))
    want = ref_config.config_as_dict(ref_config.load_config(str(path),
                                                            env=env))
    assert want["filter_backend"] == env.get("MAXMQ_FILTER_BACKEND",
                                             backend)
    if want["filter_backend"] == "jnp":
        want["filter_backend"] = "torch"
    assert got == want
    assert got["mqtt_session_expiry_interval"] == 300
    assert got["matcher_deadline_ms"] == 125


def test_load_config_missing_file_and_search(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert config.read_config_file() == ref_config.read_config_file()
    (tmp_path / "maxmq.conf").write_text('log_level = "error"\n')
    assert config.read_config_file() == ref_config.read_config_file() \
        == {"log_level": "error"}
    with pytest.raises(FileNotFoundError):
        config.read_config_file(str(tmp_path / "nope.conf"))


@pytest.mark.parametrize("value", [True, False, "1", "yes", "On", "0", "no",
                                   "", 3, "7", 2.5])
@pytest.mark.parametrize("typ", [bool, int, float, str])
def test_coerce_equal(value, typ):
    try:
        want = ref_config._coerce(value, typ)
    except ValueError:
        with pytest.raises(ValueError):
            config._coerce(value, typ)
        return
    assert config._coerce(value, typ) == want


class _FixedClock:
    """time.time_ns / time.sleep for the snowflake generator: ms ticks
    that repeat, go back once, and move on."""

    def __init__(self, ms_seq):
        self.seq = list(ms_seq)
        self.i = 0

    def time_ns(self):
        ms = self.seq[min(self.i, len(self.seq) - 1)]
        self.i += 1
        return (ms + snowflake.EPOCH_MS) * 1_000_000

    def sleep(self, _s):
        pass


MS_SEQ = [5, 5, 5, 6, 6, 4, 4, 5, 7, 7, 7, 7, 9] + [12] * 5 + list(range(13, 40))


def _ids(mod, machine, monkeypatch, n):
    clock = _FixedClock(MS_SEQ)
    monkeypatch.setattr(mod, "time", clock)
    gen = mod.Snowflake(machine)
    return [gen.next_id() for _ in range(n)]


@pytest.mark.parametrize("machine", [0, 1, 513, 1023])
def test_snowflake_under_a_fixed_clock(monkeypatch, machine):
    got = _ids(snowflake, machine, monkeypatch, 25)
    want = _ids(ref_snowflake, machine, monkeypatch, 25)
    assert got == want
    assert len(set(got)) == len(got) and got == sorted(got)
    for i in got:
        assert snowflake.Snowflake.machine_of(i) == machine
        assert snowflake.Snowflake.timestamp_ms(i) == \
            ref_snowflake.Snowflake.timestamp_ms(i)
        assert snowflake.Snowflake.sequence_of(i) == \
            ref_snowflake.Snowflake.sequence_of(i)


def test_snowflake_sequence_exhaustion_and_bounds(monkeypatch):
    seq = [3] * (snowflake.MAX_SEQUENCE + 3) + [4] * 4
    for mod in (snowflake, ref_snowflake):
        monkeypatch.setattr(mod, "time", _FixedClock(seq))
    gens = snowflake.Snowflake(2), ref_snowflake.Snowflake(2)
    a, b = ([g.next_id() for _ in range(snowflake.MAX_SEQUENCE + 2)]
            for g in gens)
    assert a == b and len(set(a)) == len(a)
    assert snowflake.Snowflake.timestamp_ms(a[-1]) == \
        snowflake.EPOCH_MS + 4
    for bad in (-1, 1024):
        with pytest.raises(ValueError) as want:
            ref_snowflake.Snowflake(bad)
        with pytest.raises(ValueError) as got:
            snowflake.Snowflake(bad)
        assert str(got.value) == str(want.value)


def _log_lines(mod, fmt, level, color, prefix, with_id):
    out = io.StringIO()
    ids = iter(range(100, 200))
    root = mod.new_logger(fmt=fmt, level=level, out=out,
                          log_id_gen=(lambda: next(ids)) if with_id
                          else None)
    root = mod.Logger(out=out, fmt=fmt, log_id_gen=root._log_id_gen,
                      color=color)
    log = root.with_prefix(prefix).with_prefix("child") if prefix else root
    log.trace("t", a=1)
    log.debug("d", topic="x/y", qos=1)
    log.info("connected", client="c1", n=3.5, ok=True)
    log.warn("w", error=ValueError("boom"))
    log.error("e", items=[1, "2"], nested={"k": b"v"})
    log.fatal("f")
    log.log(mod.INFO, "via log", k="v")
    return out.getvalue()


@pytest.mark.parametrize("fmt", ["json", "pretty", "text"])
@pytest.mark.parametrize("level", ["trace", "info", "error", 1])
@pytest.mark.parametrize("color", [False, True])
def test_logger_lines_equal(monkeypatch, fmt, level, color):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    for prefix, with_id in (("", False), ("mqtt", True)):
        got = _log_lines(logger, fmt, level, color, prefix, with_id)
        want = _log_lines(ref_logger, fmt, level, color, prefix, with_id)
        assert got == want
        if fmt == "json" and got:
            first = json.loads(got.splitlines()[0])
            assert first["time"] == 1_700_000_000_250
    logger.set_severity_level("info")
    ref_logger.set_severity_level("info")


def test_logger_rejects_the_same_inputs():
    for mod in (logger, ref_logger):
        with pytest.raises(ValueError):
            mod.set_severity_level("verbose")
        with pytest.raises(ValueError):
            mod.Logger(fmt="xml")
    assert logger._LEVEL_NAMES == ref_logger._LEVEL_NAMES
    assert logger._COLORS == ref_logger._COLORS


@pytest.mark.parametrize("fields", [("1.2.3", "", "", "maxmq-tpu"),
                                    ("2.0", "abc123", "", "dist"),
                                    ("2.0", "abc123", "2026-01-01", "d")])
def test_build_info_equal(fields):
    got, want = build.BuildInfo(*fields), ref_build.BuildInfo(*fields)
    assert got.long_version() == want.long_version()
    assert got.short_version() == want.short_version()
    assert dataclasses.astuple(build.get_info()) == \
        dataclasses.astuple(ref_build.get_info())
