"""
JSON of analysis results, as audio_analysis_tpu/utils/jsonio.py writes it:
result dataclasses field by field in declaration order, arrays of more than
8192 elements summarised as {shape, dtype, min, max} (over the finite
values) unless `full_arrays`, and NaN / +-Inf written as null so the file
is strict JSON.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Any

import numpy as np

_ARRAY_INLINE_LIMIT = 8192  # elements


def _convert(value: Any, full_arrays: bool) -> Any:
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return {f.name: _convert(getattr(value, f.name), full_arrays) for f in dataclasses.fields(value)}
    if isinstance(value, np.ndarray):
        if np.iscomplexobj(value):
            return {"real": _convert(value.real, full_arrays), "imag": _convert(value.imag, full_arrays)}
        if full_arrays or value.size <= _ARRAY_INLINE_LIMIT:
            return value.tolist()
        finite = value[np.isfinite(value)] if np.issubdtype(value.dtype, np.floating) else value
        return {
            "shape": list(value.shape),
            "dtype": str(value.dtype),
            "min": float(finite.min()) if finite.size else None,
            "max": float(finite.max()) if finite.size else None,
        }
    if isinstance(value, (np.floating, np.integer, np.bool_)):
        return value.item()
    if isinstance(value, Path):
        return str(value)
    if isinstance(value, dict):
        return {str(k): _convert(v, full_arrays) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_convert(v, full_arrays) for v in value]
    return value


def _sanitize(value: Any) -> Any:
    """NaN / +-Inf -> null (bare NaN tokens are not JSON)."""
    if isinstance(value, float):
        return value if math.isfinite(value) else None
    if isinstance(value, dict):
        return {k: _sanitize(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_sanitize(v) for v in value]
    return value


def results_to_json(results: Any, full_arrays: bool = False) -> str:
    """Any analysis result tree (dataclasses, arrays, dicts, lists) as
    strict JSON."""
    return json.dumps(_sanitize(_convert(results, full_arrays)), indent=1, allow_nan=False)


def write_results_json(path: str | Path, results: Any, full_arrays: bool = False) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(results_to_json(results, full_arrays) + "\n")
    return path
