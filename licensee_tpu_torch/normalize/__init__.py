from licensee_tpu_torch.normalize.pipeline import NormalizedContent, wrap

__all__ = ["NormalizedContent", "wrap"]
