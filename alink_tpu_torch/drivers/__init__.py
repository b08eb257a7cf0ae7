"""Drivers (counterpart of ``alink_tpu.drivers``): A-LINK on DFW
(``alink``), its ArcFace configuration (``alink_arc``) and the Multi-PIE
cross-resolution variant (``alink_mtp``); the classical active-learning
baselines (``existing_al``, ``existing_al_mtp``); and ``visualize_noise``."""
