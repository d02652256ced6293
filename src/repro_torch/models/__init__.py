"""Model zoo: unified LM API over dense/moe/ssm/hybrid/vlm/audio families
(the twin of ``repro.models``)."""

from repro_torch.models.lm import (  # noqa: F401
    ParallelCtx,
    abstract_cache,
    abstract_params,
    decode_step,
    forward,
    init_cache,
    init_params,
    prefill,
)
