"""MTCNN cascade and FaceModel (counterpart of ``alink_tpu.detect``)."""

from alink_tpu_torch.detect.cascade import (CascadeConfig, Detections,
                                            MTCNNParams, align_faces,
                                            detect_faces,
                                            detect_faces_limited,
                                            init_cascade_params,
                                            pyramid_scales)
from alink_tpu_torch.detect.face_model import FaceModel

__all__ = ["CascadeConfig", "Detections", "MTCNNParams", "align_faces",
           "detect_faces", "detect_faces_limited", "init_cascade_params",
           "pyramid_scales", "FaceModel"]
