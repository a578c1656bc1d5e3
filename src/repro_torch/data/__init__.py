from .pipeline import DataConfig, SyntheticLM, make_batch_specs
