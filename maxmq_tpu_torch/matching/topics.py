"""Topic-name / topic-filter utilities shared by the CPU trie and the
signature compiler: level splitting, validation, `$share` parsing,
tokenization and the batch bucket ladder.

Copy of the JAX package's ``matching/topics.py``; the tokenizer here is
the pure-Python path (this package does not load the native runtime).
Parity surface: MQTT spec 4.7.
"""

from __future__ import annotations

import numpy as np

SHARE_PREFIX = "$share"


def split_levels(topic: str) -> list[str]:
    """Split a topic/filter on '/' keeping empty levels ('a//b' -> 3 levels)."""
    return topic.split("/")


def parse_share(filter_: str) -> tuple[str, str]:
    """Return (group, inner_filter); group == '' for non-shared filters."""
    if not filter_.startswith(SHARE_PREFIX + "/"):
        return "", filter_
    rest = filter_[len(SHARE_PREFIX) + 1:]
    group, sep, inner = rest.partition("/")
    if not sep:
        return group, ""
    return group, inner


def _strip_valid_share(filter_: str, shared_allowed: bool) -> str | None:
    """For `$share/{group}/{filter}`, validate the share envelope
    [MQTT-4.8.2-1/2] and return the inner filter; None = invalid."""
    if not filter_.startswith(SHARE_PREFIX + "/"):
        return filter_
    if not shared_allowed:
        return None
    group, inner = parse_share(filter_)
    if group == "" or "+" in group or "#" in group:
        return None
    return inner or None


def valid_filter(filter_: str, shared_allowed: bool = True,
                 wildcards_allowed: bool = True) -> bool:
    """MQTT 4.7.1 filter validity, incl. `$share/{group}/{filter}` rules."""
    if filter_ == "":
        return False  # [MQTT-4.7.3-1]
    filter_ = _strip_valid_share(filter_, shared_allowed)
    if filter_ is None:
        return False
    levels = split_levels(filter_)
    for i, level in enumerate(levels):
        if "#" in level:
            if not wildcards_allowed:
                return False
            # '#' must be alone in its level and the last level [MQTT-4.7.1-2]
            if level != "#" or i != len(levels) - 1:
                return False
        elif "+" in level:
            if not wildcards_allowed:
                return False
            if level != "+":  # '+' must occupy an entire level [MQTT-4.7.1-3]
                return False
    return True


def valid_topic_name(topic: str) -> bool:
    """Publish topic names: non-empty, no wildcards [MQTT-3.3.2-2]."""
    return topic != "" and "+" not in topic and "#" not in topic


def is_dollar(topic: str) -> bool:
    """Topics beginning with '$' are excluded from root-level wildcard
    matching [MQTT-4.7.2-1]."""
    return topic.startswith("$")


def filter_matches_topic(flevels, topic_levels, dollar: bool) -> bool:
    """Exact CPU check: does a (non-`$share`) filter match a topic?

    Mirrors the trie walk semantics: '+' matches exactly one level
    [MQTT-4.7.1-3], a trailing '#' matches the parent and anything deeper
    [MQTT-4.7.1.2], and top-level wildcards never match '$'-topics
    [MQTT-4.7.2-1]. Used to verify device candidates (hash collisions
    are a perf event, never a correctness event)."""
    if not flevels:
        return False
    if dollar and flevels[0] in ("+", "#"):
        return False
    for i, fl in enumerate(flevels):
        if fl == "#":
            return True
        if i >= len(topic_levels):
            return False
        if fl != "+" and fl != topic_levels[i]:
            return False
    return len(topic_levels) == len(flevels)


UNK = 0  # token id reserved for levels never seen in any filter


def intern_level(vocab: dict[str, int], level: str) -> int:
    """Assign/look up the token id for a level string (0 reserved for UNK)."""
    tok = vocab.get(level)
    if tok is None:
        tok = len(vocab) + 1
        vocab[level] = tok
    return tok


def tokenize_topics(vocab: dict[str, int], topics: list[str],
                    max_levels: int):
    """Host-side topic prep: token ids padded with -1, lengths, $-flags.
    Topics deeper than max_levels report length -1 (engines fall back to
    the CPU trie)."""
    batch = len(topics)
    toks = np.full((batch, max_levels), -1, dtype=np.int32)
    lengths = np.zeros(batch, dtype=np.int32)
    dollar = np.zeros(batch, dtype=bool)
    for i, topic in enumerate(topics):
        levels = split_levels(topic)
        dollar[i] = topic.startswith("$")
        if len(levels) > max_levels:
            lengths[i] = -1
            continue
        lengths[i] = len(levels)
        for j, level in enumerate(levels):
            toks[i, j] = vocab.get(level, UNK)
    return toks, lengths, dollar


def batch_bucket(b: int) -> int:
    """Batch-axis bucket ladder: 16, powers of FOUR to 4096, powers of two
    beyond. The same ladder as the JAX package, so a padded batch holds
    the same pad rows in both and the device outputs stay comparable
    row for row. SigEngine.warm_buckets walks this same ladder."""
    if b <= 16:
        return 16
    n = (b - 1).bit_length()
    if b <= 4096:
        return 1 << (n + (n & 1))
    return 1 << n
