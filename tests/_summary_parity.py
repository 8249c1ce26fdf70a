"""Comparison of two analysis summaries (text) by structure and numbers,
and of two JSON result trees by keys, shared by the port's per-file tests
on the CPU and on the card and by chip_smoke.py. Checks raise
AssertionError explicitly, so they hold under `python -O` too."""

import re

_ANY_NUM = re.compile(r"-?\d+(?:\.\d+)?")


def assert_summaries_agree(ref: str, got: str, rel: float, abs_: float, what: str) -> None:
    """Same lines with their numbers replaced by '#', and every number
    within max(abs_, rel * magnitude) of the reference's."""
    ref, got = ref.rstrip(), got.rstrip()
    if [_ANY_NUM.sub("#", x) for x in got.splitlines()] != [_ANY_NUM.sub("#", x) for x in ref.splitlines()]:
        raise AssertionError(f"{what}: summary structure differs\n{got}\n---\n{ref}")
    a = [float(v) for v in _ANY_NUM.findall(got)]
    b = [float(v) for v in _ANY_NUM.findall(ref)]
    for i, (x, y) in enumerate(zip(a, b)):
        if abs(x - y) > max(abs_, rel * max(abs(x), abs(y))):
            raise AssertionError(f"{what}: value {i}: {x} vs {y}\n{got}\n---\n{ref}")


def json_skeleton(value):
    """A JSON tree with every leaf replaced by its type (lists longer than
    64 by their length)."""
    if isinstance(value, dict):
        return {k: json_skeleton(v) for k, v in value.items()}
    if isinstance(value, list):
        return [json_skeleton(v) for v in value] if len(value) <= 64 else ["list", len(value)]
    return "number" if isinstance(value, (int, float)) and not isinstance(value, bool) else type(value).__name__
