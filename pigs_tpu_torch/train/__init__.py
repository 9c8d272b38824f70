from pigs_tpu_torch.train.pn import (TrainConfig, init_training, pn_epoch,
                                     pn_step, rollout, rollout_metrics, train,
                                     train_epoch)

__all__ = ["TrainConfig", "init_training", "pn_step", "pn_epoch",
           "train_epoch", "train", "rollout", "rollout_metrics"]
