"""Local-mode cluster environments (ref yt/python/yt/environment)."""

from ytsaurus_tpu_torch.environment.local import LocalCluster

__all__ = ["LocalCluster"]
