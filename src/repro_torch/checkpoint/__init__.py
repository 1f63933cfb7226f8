from repro_torch.checkpoint.store import (latest_step,  # noqa: F401
                                          load_checkpoint, save_checkpoint)
