"""Training (counterpart of ``alink_tpu.train``): Keras-semantics losses,
Adadelta steps and epoch control, checkpoints, the stacked committee, the
identification classifiers' trainer."""

from alink_tpu_torch.train.checkpoint import maybe_restore, restore, save
from alink_tpu_torch.train.classifier import (categorical_crossentropy,
                                              classifier_eval_step,
                                              classifier_train_step,
                                              create_classifier_state,
                                              fit_classifier)
from alink_tpu_torch.train.ensemble import (EnsembleState,
                                            create_ensemble_state,
                                            ensemble_train_step,
                                            train_ensemble)
from alink_tpu_torch.train.losses import (accuracy, binary_crossentropy,
                                          class_weights_from_labels, one_hot)
from alink_tpu_torch.train.trainer import (EpochLog, TrainState, adadelta,
                                           custom_train, eval_step, fit,
                                           test_accuracy, train_step)

__all__ = ["maybe_restore", "restore", "save", "categorical_crossentropy",
           "classifier_eval_step", "classifier_train_step",
           "create_classifier_state", "fit_classifier", "EnsembleState",
           "create_ensemble_state", "ensemble_train_step", "train_ensemble",
           "accuracy", "binary_crossentropy", "class_weights_from_labels",
           "one_hot", "EpochLog", "TrainState", "adadelta", "custom_train",
           "eval_step", "fit", "test_accuracy", "train_step"]
