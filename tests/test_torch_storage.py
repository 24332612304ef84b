"""The port's ``hooks/storage.py`` against the JAX package's: the records'
JSON, the storage hook's writes and restore getters on a MemoryStore and a
SQLiteStore, torn-record quarantine, the ``storage.restore`` fault site,
the crash points (with ``kill_fn`` swapped), corrupt-file move-aside, and a
SQLite file written by one package restored by the other, both ways."""

import json
import os
import sqlite3
import types

import pytest

import maxmq_tpu.broker.inflight as ref_inflight
import maxmq_tpu.broker.sys_info as ref_sys_info
import maxmq_tpu.faults as ref_faults
import maxmq_tpu.hooks.storage as ref_storage
import maxmq_tpu.protocol.codec as ref_codec
import maxmq_tpu.protocol.packets as ref_packets
import maxmq_tpu_torch.broker.inflight as port_inflight
import maxmq_tpu_torch.broker.sys_info as port_sys_info
import maxmq_tpu_torch.faults as port_faults
import maxmq_tpu_torch.hooks.storage as port_storage
import maxmq_tpu_torch.protocol.codec as port_codec
import maxmq_tpu_torch.protocol.packets as port_packets
from maxmq_tpu_torch.hooks import SQLiteStore, StorageHook

KITS = {
    "ref": types.SimpleNamespace(
        storage=ref_storage, faults=ref_faults, codec=ref_codec,
        packets=ref_packets, inflight=ref_inflight, sys_info=ref_sys_info),
    "port": types.SimpleNamespace(
        storage=port_storage, faults=port_faults, codec=port_codec,
        packets=port_packets, inflight=port_inflight,
        sys_info=port_sys_info),
}
BUCKETS = ("clients", "subscriptions", "retained", "inflight", "sysinfo",
           "meta", "quarantine")


def both(fn):
    out = {name: fn(kit) for name, kit in KITS.items()}
    assert out["port"] == out["ref"]
    return out["port"]


def packet(kit, ptype="PUBLISH", **kw):
    fixed = {k: kw.pop(k) for k in ("qos", "retain") if k in kw}
    props = kw.pop("props", {})
    p = kit.packets.Packet(
        fixed=kit.codec.FixedHeader(type=getattr(kit.codec.PacketType,
                                                 ptype), **fixed), **kw)
    for k, v in props.items():
        setattr(p.properties, k, v)
    return p


V5_PROPS = {"payload_format": 1, "message_expiry": 30,
            "content_type": "json", "response_topic": "r/t",
            "correlation_data": b"\x01\x02", "subscription_ids": [4],
            "user_properties": [("k", "v"), ("k", "w")]}


def client(kit, cid="c1", version=5):
    props = types.SimpleNamespace(username=b"u\xc3\xa9", clean_start=False,
                                  protocol_version=version,
                                  session_expiry=120,
                                  session_expiry_set=True)
    return types.SimpleNamespace(
        id=cid, listener="t1", properties=props, disconnected_at=12.5,
        inflight=kit.inflight.Inflight(), held_pids=[7], server=None)


def drive(kit, hook):
    """The broker's write-through events, in one fixed order."""
    c1, c2 = client(kit), client(kit, "c2", 4)
    hook.on_session_established(c1, None)
    hook.on_session_established(c2, None)
    sub = packet(kit, "SUBSCRIBE", packet_id=1, filters=[
        kit.packets.Subscription(filter="a/+", qos=1, no_local=True,
                                 identifier=3),
        kit.packets.Subscription(filter="bad/#", qos=2),
        kit.packets.Subscription(filter="$share/g/x", qos=0)])
    hook.on_subscribed(c1, sub, [1, 0x80, 0], None)
    hook.on_subscribed(c2, sub, [0, 0, 0], None)
    hook.on_unsubscribed(c2, packet(kit, "UNSUBSCRIBE", packet_id=2,
                                    filters=[kit.packets.Subscription(
                                        filter="bad/#")]))
    hook.on_retain_message(c1, packet(kit, topic="r/1", payload=b"v1",
                                      qos=1, retain=True,
                                      protocol_version=5, props=V5_PROPS),
                           1)
    hook.on_retain_message(c1, packet(kit, topic="r/2", payload=b"v2",
                                      retain=True), 1)
    hook.on_retain_message(c1, packet(kit, topic="r/2", payload=b"",
                                      retain=True), -1)
    for pid in (5, 7, 9):
        p = packet(kit, topic=f"q/{pid}", payload=b"\x00\xff", qos=2,
                   packet_id=pid, protocol_version=5)
        c1.inflight.set(p)
        hook.on_qos_publish(c1, p, 0.0, 0)
    hook.on_qos_publish(c1, c1.inflight.get(5), 0.0, 1)     # a resend
    hook.on_qos_complete(c1, packet(kit, "PUBCOMP", packet_id=9))
    hook.on_qos_dropped(c1, packet(kit, "PUBCOMP", packet_id=11))
    info = kit.sys_info.SysInfo(version="1", clients_connected=2,
                                messages_sent=40)
    info.extra["x"] = 1
    hook.on_sys_info_tick(info)
    hook.on_disconnect(c2, None, False)
    return c1


def contents(store):
    return {b: store.all(b) for b in BUCKETS}


def restored(hook):
    def recs(items):
        return sorted(json.dumps(r.__dict__, default=repr, sort_keys=True)
                      for r in items)

    info = hook.stored_sys_info()
    return {"clients": recs(hook.stored_clients()),
            "subscriptions": recs(hook.stored_subscriptions()),
            "retained": recs(hook.stored_retained_messages()),
            "inflight": recs(hook.stored_inflight_messages()),
            "sysinfo": None if info is None else info.__dict__,
            "quarantined": hook.quarantined}


def test_records_json_round_trip_across_packages():
    def run(kit):
        S = kit.storage
        p = packet(kit, topic="t/x", payload=b"\x00hi", qos=1, retain=True,
                   packet_id=4, protocol_version=5, props=V5_PROPS)
        recs = [S.ClientRecord("c", "l", b"user", True, 5, 9, True, 1.5),
                S.SubscriptionRecord("c", "a/#", 2, True, True, 1, 7,
                                     "$expr=payload.t>1"),
                S.MessageRecord.from_packet(p, "c")]
        out = [r.to_json() for r in recs]
        back = [type(r).from_json(j) for r, j in zip(recs, out)]
        out += [b.to_json() for b in back]
        out.append(back[2].to_packet().encode())
        # a newer schema's extra keys are dropped, not fatal
        d = json.loads(out[1])
        d["future_field"] = 1
        out.append(S.SubscriptionRecord.from_json(json.dumps(d)).to_json())
        return out

    out = both(run)
    # each package decodes the other's JSON to the same record
    for kit in KITS.values():
        for cls, j in zip(("ClientRecord", "SubscriptionRecord",
                           "MessageRecord"), out[:3]):
            assert getattr(kit.storage, cls).from_json(j).to_json() == j


@pytest.mark.parametrize("backend", ["memory", "sqlite"])
def test_hook_writes_and_restores_equal(tmp_path, backend):
    def run(kit):
        S = kit.storage
        store = (S.MemoryStore() if backend == "memory" else
                 S.SQLiteStore(str(tmp_path / f"{id(kit)}.db")))
        hook = S.StorageHook(store)
        c1 = drive(kit, hook)
        rec = [contents(store), restored(hook), hook.rewrites_skipped,
               hook.journal_sheds, sorted(c1.inflight._stored)]
        hook.on_client_expired(c1)
        rec.append(contents(store))
        hook.stop()
        return rec

    rec = both(run)
    assert rec[2] == 1 and len(rec[0]["inflight"]) == 2
    assert '"held": true' in rec[0]["inflight"]["c1|7"]


def test_quarantine_restore_fault_and_crash_point():
    def run(kit):
        S, f = kit.storage, kit.faults
        store = S.MemoryStore()
        hook = S.StorageHook(store)
        drive(kit, hook)
        store.put("subscriptions", "c9|torn", '{"client_id": "c9", "fil')
        store.put("sysinfo", "sysinfo", "not json")
        rec = [restored(hook), contents(store)]
        killed = []
        saved = f.REGISTRY.kill_fn
        f.clear()
        try:
            f.arm(f.STORAGE_RESTORE, "raise", 1)
            rec.append(restored(hook))
            rec.append(dict(f.fired))
            f.REGISTRY.kill_fn = lambda: killed.append(1)
            f.arm_from_spec(f"{f.CRASH_AT}#restore_parse:kill:1")
            hook.stored_clients()
            rec.append(len(killed))
        finally:
            f.REGISTRY.kill_fn = saved
            f.clear()
        rec.append(contents(store)["quarantine"])
        return rec

    rec = both(run)
    assert rec[0]["quarantined"] == 2 and rec[0]["sysinfo"] is None
    assert rec[3] == {"storage.restore": 1} and rec[4] == 1


def test_boot_epoch_is_monotonic():
    def run(kit):
        hook = kit.storage.StorageHook(kit.storage.MemoryStore())
        first = hook.bump_boot_epoch()
        return [hook.bump_boot_epoch() - first, hook.bump_boot_epoch()
                - first, first > 10 ** 12]

    assert both(run) == [1, 2, True]


def test_sqlite_apply_batch_is_all_or_nothing(tmp_path):
    """A crash inside the open transaction (``mid_wal_write``) leaves
    none of the batch; a clean batch lands whole."""
    class Crash(Exception):
        pass

    def run(kit):
        S, f = kit.storage, kit.faults
        path = str(tmp_path / f"batch-{id(kit)}.db")
        store = S.SQLiteStore(path)
        store.put("retained", "keep", "1")
        ops = [("put", "retained", f"k{i}", str(i)) for i in range(6)]
        ops += [("delete", "retained", "keep", None),
                ("delete_prefix", "retained", "k1", None)]
        saved = f.REGISTRY.kill_fn
        f.clear()

        def crash():
            raise Crash()

        try:
            f.REGISTRY.kill_fn = crash
            f.arm(f"{f.CRASH_AT}#mid_wal_write", "kill", 1)
            with pytest.raises(Crash):
                store.apply_batch(ops)
        finally:
            f.REGISTRY.kill_fn = saved
            f.clear()
        rec = [store.all("retained")]
        store.apply_batch(ops)
        rec.append(store.all("retained"))
        store.close()
        return rec

    rec = both(run)
    assert rec[0] == {"keep": "1"} and "keep" not in rec[1]


def test_corrupt_file_is_moved_aside(tmp_path):
    def run(kit):
        d = tmp_path / f"c{id(kit)}"
        d.mkdir()
        path = str(d / "store.db")
        with open(path, "wb") as fh:
            fh.write(b"SQLite format 3\x00" + b"\xde\xad" * 2000)
        store = kit.storage.SQLiteStore(path)
        store.put("clients", "a", "{}")
        rec = [store.corruptions, store.aside_failures,
               sorted(os.listdir(d)), store.all("clients")]
        store.close()
        return rec

    rec = both(run)
    assert rec[0] == 1 and "store.db.corrupt-1" in rec[2]


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_sqlite_file_crosses_between_packages(tmp_path, writer):
    """An operator's database survives the move: the file one package's
    hook wrote restores in the other's to equal records, and its writes
    after that read back in the first."""
    reader = "port" if writer == "ref" else "ref"
    path = str(tmp_path / "cross.db")
    w, r = KITS[writer], KITS[reader]
    hook = w.storage.StorageHook(w.storage.SQLiteStore(path))
    drive(w, hook)
    want = restored(hook)
    want_rows = contents(hook.store)
    hook.stop()
    other = r.storage.StorageHook(r.storage.SQLiteStore(path))
    assert other.store.corruptions == 0
    assert contents(other.store) == want_rows
    assert restored(other) == want
    other.on_retain_message(client(r), packet(r, topic="r/9", payload=b"z",
                                              retain=True), 1)
    other.on_client_expired(client(r))
    other.stop()
    back = w.storage.StorageHook(w.storage.SQLiteStore(path))
    got = restored(back)
    back.stop()
    assert any('"topic": "r/9"' in m for m in got["retained"])
    assert not any('"client_id": "c1"' in c for c in got["clients"])
    con = sqlite3.connect(path)
    assert con.execute("PRAGMA quick_check").fetchone()[0] == "ok"
    con.close()


def test_port_store_exports():
    assert StorageHook is port_storage.StorageHook
    assert SQLiteStore is port_storage.SQLiteStore
