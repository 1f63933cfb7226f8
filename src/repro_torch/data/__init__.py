from repro_torch.data.pipeline import (DataState,  # noqa: F401
                                       SyntheticLMDataset, shard_assignment)
