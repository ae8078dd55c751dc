"""Model state: the incremental Gaussian map."""

from gaussian_lic_tpu_torch.models.gaussians import GaussianMap, LearningRates

__all__ = ["GaussianMap", "LearningRates"]
