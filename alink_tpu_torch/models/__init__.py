"""Models (counterpart of ``alink_tpu.models``)."""

from alink_tpu_torch.models import preprocess
from alink_tpu_torch.models.arcface import (ArcFaceResNet34, ArcFaceResNet50,
                                            ArcFaceResNet100)
from alink_tpu_torch.models.classify import (ResNet50Classifier,
                                             SENet50Classifier,
                                             SmallResClassifier,
                                             VGG16Classifier)
from alink_tpu_torch.models.genderage import (GenderAgeHead,
                                              GenderAgeResNet50, decode_ga)
from alink_tpu_torch.models.mtcnn import LNet, ONet, PNet, RNet
from alink_tpu_torch.models.resnet import (ResNet50V15, SENet50, VGGFace16,
                                           VGGFaceResNet50)
from alink_tpu_torch.models.retinaface import RetinaFaceR50
from alink_tpu_torch.models.siamese import SiameseHead, SmallRes, SmallResTower
from alink_tpu_torch.models.swin import FaceSwin, FaceSwin_S
from alink_tpu_torch.models.vit import FaceViT, FaceViT_L

__all__ = ["preprocess", "ArcFaceResNet34", "ArcFaceResNet50",
           "ArcFaceResNet100", "ResNet50Classifier", "SENet50Classifier",
           "SmallResClassifier", "VGG16Classifier", "GenderAgeHead",
           "GenderAgeResNet50", "decode_ga", "LNet", "ONet", "PNet", "RNet",
           "SENet50", "VGGFace16", "SiameseHead", "SmallRes", "SmallResTower",
           "VGGFaceResNet50", "FaceViT", "FaceViT_L", "ResNet50V15",
           "RetinaFaceR50", "FaceSwin", "FaceSwin_S"]
