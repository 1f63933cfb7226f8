from repro_torch.optim.adamw import AdamW, AdamWState, adamw  # noqa: F401
from repro_torch.optim.schedules import (cosine_schedule,  # noqa: F401
                                         linear_warmup_cosine)
from repro_torch.optim.compression import (  # noqa: F401
    compress_gradients, decompress_gradients, error_feedback_update)
