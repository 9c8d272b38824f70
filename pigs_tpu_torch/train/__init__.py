from pigs_tpu_torch.train.pn import rollout, rollout_metrics

__all__ = ["rollout", "rollout_metrics"]
