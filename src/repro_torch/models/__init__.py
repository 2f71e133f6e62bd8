"""The language model and its layers: the LM shell plus per-family
block implementations (dense / MoE / SSM / hybrid / encoder-decoder)."""
from repro_torch.models.lm import (LM, PlanUnit, block_apply,  # noqa: F401
                                   block_init, build_model)
