from repro_torch.data.pipeline import (DataState,  # noqa: F401
                                       SyntheticLMDataset, TensorSpec,
                                       make_batch_specs, shard_assignment)
