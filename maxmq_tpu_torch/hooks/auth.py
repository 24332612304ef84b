"""Authentication hooks: permit-all and a rule-ledger hook.

Parity surface: vendor/github.com/mochi-co/mqtt/v2/hooks/auth/ in the
reference (AllowHook, Ledger with auth rules + ACL filters).

Copy of the JAX package's ``hooks/auth.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .base import Hook


class AllowHook(Hook):
    """Permit every connection and every ACL check."""

    id = "allow-all-auth"

    def on_connect_authenticate(self, client, packet) -> bool:
        return True

    def on_acl_check(self, client, topic: str, write: bool) -> bool:
        return True


def _match_rule_value(rule_value: str, actual: str) -> bool:
    """Ledger matching: empty matches anything; trailing '*' is a prefix
    wildcard; otherwise exact."""
    if rule_value == "":
        return True
    if rule_value.endswith("*"):
        return actual.startswith(rule_value[:-1])
    return rule_value == actual


@dataclass
class AuthRule:
    username: str = ""
    password: str = ""
    remote: str = ""
    client_id: str = ""
    allow: bool = True

    def matches(self, username: str, password: str, remote: str,
                client_id: str) -> bool:
        return (_match_rule_value(self.username, username)
                and _match_rule_value(self.remote, remote)
                and _match_rule_value(self.client_id, client_id)
                and (self.password == "" or self.password == password))


@dataclass
class ACLRule:
    username: str = ""
    remote: str = ""
    client_id: str = ""
    # filter -> access: "deny" | "read" | "write" | "readwrite"
    filters: dict[str, str] = field(default_factory=dict)

    def check(self, username: str, remote: str, client_id: str, topic: str,
              write: bool) -> bool | None:
        """None = rule does not apply; True/False = allow/deny."""
        if not (_match_rule_value(self.username, username)
                and _match_rule_value(self.remote, remote)
                and _match_rule_value(self.client_id, client_id)):
            return None
        for filt, access in self.filters.items():
            if _filter_covers(filt, topic):
                if access == "deny":
                    return False
                if access == "readwrite":
                    return True
                return access == ("write" if write else "read")
        return None


def _filter_covers(filter_: str, topic: str) -> bool:
    """Does an ACL filter (with MQTT wildcards) cover a concrete topic?"""
    flevels = filter_.split("/")
    tlevels = topic.split("/")
    for i, fl in enumerate(flevels):
        if fl == "#":
            return True
        if i >= len(tlevels):
            return False
        if fl != "+" and fl != tlevels[i]:
            return False
    return len(flevels) == len(tlevels)


@dataclass
class Ledger:
    auth: list[AuthRule] = field(default_factory=list)
    acl: list[ACLRule] = field(default_factory=list)

    @classmethod
    def from_dict(cls, data: dict) -> "Ledger":
        ledger = cls()
        for r in data.get("auth", []):
            ledger.auth.append(AuthRule(**r))
        for r in data.get("acl", []):
            ledger.acl.append(ACLRule(**r))
        return ledger

    @classmethod
    def from_json(cls, text: str) -> "Ledger":
        import json
        return cls.from_dict(json.loads(text))

    @classmethod
    def from_yaml(cls, text: str) -> "Ledger":
        import yaml
        return cls.from_dict(yaml.safe_load(text) or {})

    @classmethod
    def from_file(cls, path: str) -> "Ledger":
        """Load rules from a .json or .yaml/.yml file (the reference's
        ledger is YAML/JSON loadable, hooks/auth/ledger.go)."""
        with open(path, encoding="utf-8") as f:
            text = f.read()
        if path.endswith((".yaml", ".yml")):
            return cls.from_yaml(text)
        return cls.from_json(text)


class LedgerHook(Hook):
    """Rule-based authentication + topic ACLs."""

    id = "ledger-auth"

    def __init__(self, ledger: Ledger) -> None:
        self.ledger = ledger

    def on_connect_authenticate(self, client, packet) -> bool:
        username = packet.username.decode("utf-8", "replace")
        password = packet.password.decode("utf-8", "replace")
        for rule in self.ledger.auth:
            if rule.matches(username, password, client.remote, client.id):
                return rule.allow
        return False

    def on_acl_check(self, client, topic: str, write: bool) -> bool:
        username = client.properties.username.decode("utf-8", "replace")
        for rule in self.ledger.acl:
            verdict = rule.check(username, client.remote, client.id, topic,
                                 write)
            if verdict is not None:
                return verdict
        return True  # no applicable rule -> allowed (reference behavior)
