"""The driver configurations (counterpart of ``alink_tpu/config.py``'s
``ALinkConfig``, ``ALinkArcConfig``, ``MTPConfig`` and
``ExistingALConfig``): the same fields, defaults and validation, kept here
so that the port imports nothing of the JAX package.

Knob names are the reference's flag names (``code/ALINK.py:37-62``).  The
TPU-only knobs (``mesh_shape``, ``featurize_scan_units``, ``device_batch=
"auto"``'s tunnel probe) are kept as fields so that configurations cross
between the packages; the port ignores or refuses them where it says so.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class ALinkConfig:
    """A-LINK / A2-LINK loop configuration; defaults are the reference
    driver's flag defaults."""

    # Paths (ALINK.py:37-42)
    data_dir_prefix: str = "DFW_Data/"
    train_images_dir: str = "Training_data"
    test_images_dir: str = "Testing_data"
    out_model: str = "models/postALINK"
    ensemble_basepath: str = "models/ensemble"
    disguised_basemodel: str = "models/disguisedModel"

    # Noise bank, comma-separated in the reference (ALINK.py:43).
    noise: Sequence[str] = (
        "gaussian",
        "saltpepper",
        "poisson",
        "speckle",
        "adversarial",
    )

    # Training schedule (ALINK.py:45-52)
    ft_epochs: int = 3
    batch_size: int = 16
    dig_epochs: int = 40
    undig_epochs: int = 60
    batch_send: int = 64
    mixture_ratio: int = 2
    alink_bs: int = 16
    num_ensemble_models: int = 1

    # Selection knobs (ALINK.py:54-57)
    active_ratio: float = 1.0
    split_ratio: float = 0.5
    disparity_ratio: float = 0.25
    eps: float = 0.05

    # Behaviour toggles (ALINK.py:59-62)
    augment: bool = False
    refine_models: bool = False
    train_disguised_model: bool = False
    blind_strategy: bool = False

    # Geometry (module constants at ALINK.py:28-32); image_res is cv2 (w, h).
    image_res: tuple[int, int] = (224, 224)
    feature_res: int = 2048

    # Additions without a reference counterpart.
    seed: int = 42  # the reference seeds TF with 42 (ALINK.py:19)
    mesh_shape: tuple[int, ...] = (-1,)
    dtype: str = "bfloat16"
    # > 0: generate a synthetic DFW-protocol tree with this many people.
    synthetic_people: int = 0
    # Samples per pretraining epoch (the reference hard-codes 320000).
    train_steps: int = 320000
    loop_checkpoint: str = ""
    checkpoint_every: int = 1
    max_restarts: int = 0
    # Pairs per selection chunk.
    device_batch: int | str = 1024
    ingest_dct_scale: bool = False
    featurize_scan_units: bool = False
    debug_nans: bool = False

    def __post_init__(self):
        if isinstance(self.device_batch, str):
            if self.device_batch != "auto":
                raise ValueError(
                    "device_batch must be a positive int or 'auto'")
        elif self.device_batch <= 0:
            raise ValueError("device_batch must be positive")
        if not (0.0 <= self.split_ratio <= 1.0):  # ALINK.py:74
            raise ValueError("split_ratio must be in [0, 1]")
        if not (0.0 <= self.disparity_ratio <= 1.0):  # ALINK.py:75
            raise ValueError("disparity_ratio must be in [0, 1]")
        if not (0.0 <= self.eps < 0.5):  # ALINK.py:76
            raise ValueError("eps must be in [0, 0.5)")
        if self.max_restarts > 0 and not self.loop_checkpoint:
            raise ValueError("max_restarts requires loop_checkpoint")


@dataclasses.dataclass(frozen=True)
class ALinkArcConfig(ALinkConfig):
    """The ArcFace driver's configuration (the reference's ALINK_arc.py):
    112x112 inputs, 512-d L2-normalised embeddings, perlin in the noise
    bank, its own model paths, and the LResNet depth of the embedder
    (34, 50 or 100).  ``embed_scan_units`` is the JAX package's
    compile-time knob; it is accepted and ignored."""

    out_model: str = "models/postALINK_arc"
    ensemble_basepath: str = "models/ensemble_arc"
    disguised_basemodel: str = "models/disguisedModel_arc"
    noise: Sequence[str] = (
        "gaussian",
        "saltpepper",
        "poisson",
        "perlin",
        "speckle",
        "adversarial",
    )
    image_res: tuple[int, int] = (112, 112)
    feature_res: int = 512
    embed_depth: int = 100
    embed_scan_units: bool = False

    def __post_init__(self):
        super().__post_init__()
        if self.embed_depth not in (34, 50, 100):
            raise ValueError(
                f"embed_depth must be 34, 50 or 100 (the LResNet zoo), "
                f"got {self.embed_depth}")


@dataclasses.dataclass(frozen=True)
class MTPConfig:
    """The Multi-PIE cross-resolution driver's configuration (the
    reference's ALINK_MTP.py:47-72): the domain gap is resolution, a 224x224
    teacher and a ``low_res`` (default 48) raw-pixel student."""

    data_dir_prefix: str = "MultiPieSplits/split1/train"
    test_dir: str = "MultiPieSplits/split1/test"
    out_model: str = "MTP_models/postALINK"
    ensemble_basepath: str = "MTP_models/ensemble"
    lowres_basemodel: str = "MTP_models/lowresModel"
    noise: Sequence[str] = ("adversarial",)  # ALINK_MTP.py:53

    low_res: int = 48  # ALINK_MTP.py:55 ("lowRes")
    ft_epochs: int = 3
    batch_size: int = 16
    lowres_epochs: int = 10
    highres_epochs: int = 5
    batch_send: int = 32
    mixture_ratio: int = 1
    alink_bs: int = 8
    num_ensemble_models: int = 1

    active_ratio: float = 1.0
    split_ratio: float = 0.5
    disparity_ratio: float = 0.25
    eps: float = 0.1  # ALINK_MTP.py:68 (the DFW driver's is 0.05)

    augment: bool = False
    refine_models: bool = False
    blind_strategy: bool = False

    # GlobalConstants (ALINK_MTP.py:36-43); image_res is cv2 (w, h).
    image_res: tuple[int, int] = (224, 224)
    feature_res: int = 2048
    normal_res: tuple[int, int] = (150, 150)

    seed: int = 42
    mesh_shape: tuple[int, ...] = (-1,)
    dtype: str = "bfloat16"
    device_batch: int | str = 1024  # see ALinkConfig.device_batch
    ingest_dct_scale: bool = False
    featurize_scan_units: bool = False
    loop_checkpoint: str = ""
    checkpoint_every: int = 1
    train_steps: int = 320000
    debug_nans: bool = False

    def __post_init__(self):
        if isinstance(self.device_batch, str):
            if self.device_batch != "auto":
                raise ValueError(
                    "device_batch must be a positive int or 'auto'")
        elif self.device_batch <= 0:
            raise ValueError("device_batch must be positive")
        if self.low_res > self.normal_res[0]:  # ALINK_MTP.py:32
            raise ValueError("low_res must be <= normal_res")
        if not (0.0 <= self.split_ratio <= 1.0):
            raise ValueError("split_ratio must be in [0, 1]")
        if not (0.0 <= self.disparity_ratio <= 1.0):
            raise ValueError("disparity_ratio must be in [0, 1]")
        if not (0.0 <= self.eps < 0.5):
            raise ValueError("eps must be in [0, 0.5)")


@dataclasses.dataclass(frozen=True)
class ExistingALConfig:
    """The classical active-learning baseline's configuration (the
    reference's existing_al.py:29-41)."""

    data_dir_prefix: str = "DFW/DFW_Data/"
    train_images_dir: str = "Training_data"
    model_path: str = "WACV_models/active"
    out_model: str = "WACV_models/post_active"
    # uncertainty_sampling | margin_sampling | entropy_sampling
    query_strategy: str = "uncertainty_sampling"

    epochs: int = 3
    batch_size: int = 512
    split_ratio: float = 0.3
    active_ratio: float = 1.0

    image_res: tuple[int, int] = (224, 224)
    feature_res: int = 2048

    seed: int = 42
    mesh_shape: tuple[int, ...] = (-1,)
    dtype: str = "bfloat16"
    ingest_dct_scale: bool = False
    featurize_scan_units: bool = False
