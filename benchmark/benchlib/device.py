"""
The card a run measures, the caches it builds into, and the modules a run
may not load.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path
from typing import Dict, List

BANNED_ROOTS = ("jax", "jaxlib", "flax", "audio_analysis_tpu")


def cache_environment(root: Path) -> Dict[str, str]:
    """Fixed cache directories inside the checkout, so only a checkout's
    first run builds or compiles: the program's CUDA library and the
    native decoder already build under build/ and cpp/build/; these cover
    what torch and the CUDA driver would cache under HOME."""
    base = root / "build" / "benchmark_cache"
    env = {
        "TORCH_EXTENSIONS_DIR": str(base / "torch_extensions"),
        "TRITON_CACHE_DIR": str(base / "triton"),
        "CUDA_CACHE_PATH": str(base / "cuda"),
        "TORCHINDUCTOR_CACHE_DIR": str(base / "inductor"),
    }
    for key, value in env.items():
        os.environ[key] = value
        Path(value).mkdir(parents=True, exist_ok=True)
    return env


def banned_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's, Flax's
    or the JAX package's (the port's name merely begins with the latter)."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".")[0] in BANNED_ROOTS})


def power_limit() -> str:
    """`name, power limit` as nvidia-smi reads them, or what went wrong."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return res.stdout.strip().splitlines()[0] if res.returncode == 0 and res.stdout.strip() else "unread"
    except (OSError, subprocess.SubprocessError):
        return "unread"


def require_cards(torch, chips: int) -> Dict:
    """The device block of the result line, or SystemExit when the cell's
    cards are not all there: nothing is measured on another device."""
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: torch.cuda.is_available() is false; nothing measured")
    count = torch.cuda.device_count()
    if count < chips:
        raise SystemExit(f"the cell needs {chips} CUDA devices and {count} are visible; nothing measured")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": int(chips)}
