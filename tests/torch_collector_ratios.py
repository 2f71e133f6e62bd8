"""The port's collected residual bytes against the reference's, per
family, on the reduced configs (2 layers, fp32, B = 2; seamless: 2
encoder and 2 decoder layers, its units' ratios in that order, over
as many frames as tokens; qwen2-vl: behind 16 vision tokens).

The two autodiffs save different tensors, so the byte ratio is data,
not a bound (ROADMAP §C records it; ``tests/test_torch_planner.py``
bounds it for the dense family only).  The FLOPs and output vectors
must be equal.  Run from the repository root to print the table:

    PYTHONPATH=src:tests python tests/torch_collector_ratios.py
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.collector import ShuttlingCollector as JaxCollector
from repro.models.lm import build_model
from repro.models.registry import get_config as jax_get_config
from repro_torch.core.collector import ShuttlingCollector
from repro_torch.models.lm import LM
from repro_torch.models.registry import get_config

# per architecture: the reduced config's overrides (hymba: a window that
# bites at these lengths)
FAMILIES = {
    "bert_base_paper": dict(d_model=128, d_ff=256, vocab_size=512),
    "granite_moe_1b_a400m": {},
    "kimi_k2_1t_a32b": {},
    "hymba_1p5b": dict(sliding_window=64, global_interval=2),
    "qwen3_1p7b": {},
    "yi_9b": {},
    "seamless_m4t_large_v2": {},
    "qwen2_vl_7b": {},
}
LENGTHS = (32, 64, 128, 256)


def collections(arch: str, impl: str):
    """{S: (port result, reference result)} for ``arch`` with the port's
    ``impl`` (the reference runs ``xla``)."""
    cfg = dict(dtype="float32", num_layers=2, **FAMILIES[arch])
    jlm = build_model(jax_get_config(arch).reduced(**cfg), attn_impl="xla")
    params = jlm.init(jax.random.PRNGKey(0))
    lm = LM(get_config(arch).reduced(**cfg), attn_impl=impl, device="cpu")
    out = {}
    for S in LENGTHS:
        stub = _stub_inputs(lm.cfg, S)
        ref = JaxCollector(jlm).collect(
            params, {"tokens": jnp.ones((2, S), jnp.int32),
                     **{k: jnp.asarray(v) for k, v in stub.items()}})
        ours = ShuttlingCollector(lm).collect(
            {"tokens": torch.ones((2, S), dtype=torch.long),
             **{k: torch.from_numpy(v) for k, v in stub.items()}})
        out[S] = (ours, ref)
    return out


def _stub_inputs(cfg, S):
    """The stub frontends' entries at text length S (B = 2): an
    encoder-decoder's ``frames`` (one per token), a vision-language
    model's ``vision_embeds``."""
    if cfg.family == "encdec":
        return {"frames": np.zeros((2, S, cfg.d_model), np.float32)}
    if cfg.family == "vlm":
        return {"vision_embeds": np.zeros((2, cfg.vision_tokens,
                                           cfg.d_model), np.float32)}
    return {}


def main() -> None:
    for arch in FAMILIES:
        for impl in ("xla", "flash"):
            ratios = {S: np.round(o.activation_vector()
                                  / r.activation_vector(), 3).tolist()
                      for S, (o, r) in collections(arch, impl).items()}
            print(f"{arch} port {impl} / reference xla: {ratios}")


if __name__ == "__main__":
    main()
