"""The process environment a run needs, set before torch is imported:
every build and kernel cache inside the checkout, the cell's allocator
setting, no injected faults, no JAX behind a library."""
import json
import os
from pathlib import Path

PERFBENCH = Path(__file__).resolve().parents[1]
ROOT = PERFBENCH.parent


def prepare(workload: str) -> None:
    cache = ROOT / "build" / "perfbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(cache / sub)
    wl = json.loads((PERFBENCH / "workloads" / f"{workload}.json")
                    .read_text())
    if wl.get("alloc_conf"):
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = wl["alloc_conf"]
    else:
        os.environ.pop("PYTORCH_CUDA_ALLOC_CONF", None)
    os.environ.pop("MIMOSE_INJECT_OOM", None)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
