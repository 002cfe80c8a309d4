from repro_torch.data.pipeline import DataConfig, make_batches, synthetic_stream

__all__ = ["DataConfig", "make_batches", "synthetic_stream"]
