"""MTCNN cascade, RetinaFace's detector and FaceModel (counterpart of
``alink_tpu.detect``; RetinaFace is the port's own)."""

from alink_tpu_torch.detect.cascade import (CascadeConfig, Detections,
                                            MTCNNParams, align_faces,
                                            detect_faces,
                                            detect_faces_limited,
                                            init_cascade_params,
                                            pyramid_scales)
from alink_tpu_torch.detect.face_model import FaceModel
from alink_tpu_torch.detect.retina import (RetinaConfig, RetinaFaceDetector,
                                           priors)

__all__ = ["CascadeConfig", "Detections", "MTCNNParams", "align_faces",
           "detect_faces", "detect_faces_limited", "init_cascade_params",
           "pyramid_scales", "FaceModel", "RetinaConfig",
           "RetinaFaceDetector", "priors"]
