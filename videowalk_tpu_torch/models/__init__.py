"""Model layer: ResNet trunk, encoder factory, CRW."""

from videowalk_tpu_torch.models.crw import CRW, CRWConfig, Head
from videowalk_tpu_torch.models.encoder import From3D, make_encoder
from videowalk_tpu_torch.models.resnet import ResNet, resnet18

__all__ = ["CRW", "CRWConfig", "Head", "From3D", "make_encoder", "ResNet",
           "resnet18"]
