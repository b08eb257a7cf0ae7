"""Models (counterpart of ``alink_tpu.models``)."""

from alink_tpu_torch.models import preprocess
from alink_tpu_torch.models.arcface import (ArcFaceResNet34, ArcFaceResNet50,
                                            ArcFaceResNet100)
from alink_tpu_torch.models.genderage import (GenderAgeHead,
                                              GenderAgeResNet50, decode_ga)
from alink_tpu_torch.models.mtcnn import LNet, ONet, PNet, RNet
from alink_tpu_torch.models.resnet import VGGFaceResNet50
from alink_tpu_torch.models.siamese import SiameseHead, SmallRes, SmallResTower

__all__ = ["preprocess", "ArcFaceResNet34", "ArcFaceResNet50",
           "ArcFaceResNet100", "GenderAgeHead", "GenderAgeResNet50",
           "decode_ga", "LNet", "ONet", "PNet", "RNet", "SiameseHead",
           "SmallRes", "SmallResTower", "VGGFaceResNet50"]
