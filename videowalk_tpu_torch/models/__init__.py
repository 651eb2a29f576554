"""Model layer: ResNet trunks, encoder factory, CRW, teacher-student CRW."""

from videowalk_tpu_torch.models.crw import CRW, CRWConfig, Head
from videowalk_tpu_torch.models.encoder import From3D, make_encoder
from videowalk_tpu_torch.models.resnet import ResNet, resnet18, resnet50
from videowalk_tpu_torch.models.teacher_student import (CRWTeacherStudent,
                                                        soft_cross_entropy)

__all__ = ["CRW", "CRWConfig", "CRWTeacherStudent", "Head", "From3D",
           "make_encoder", "ResNet", "resnet18", "resnet50",
           "soft_cross_entropy"]
