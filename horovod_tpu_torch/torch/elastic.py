"""Elastic state and sampler for the torch frontend.

Port of the JAX package's ``torch/elastic.py`` (reference:
horovod/torch/elastic/state.py TorchState with its model and optimizer
handlers :30-255, and elastic/sampler.py ElasticSampler :24). A commit
holds ``state_dict()`` deep copies on the tensors' own device, so a model
on the GPU commits on the GPU; ``sync`` broadcasts rank 0's state.
"""

import copy

import torch

from horovod_tpu_torch.elastic.state import ObjectState
from horovod_tpu_torch.elastic.state import run  # noqa: F401  (re-export;
#   reference: horovod/torch/elastic/__init__.py:23 def run)
from horovod_tpu_torch.torch.functions import (broadcast_object,
                                               broadcast_optimizer_state,
                                               broadcast_parameters)


class TorchState(ObjectState):
    """Elastic state of a torch model and optimizer plus any Python
    attributes (reference: torch/elastic/state.py:30-125: the model and the
    optimizer have handlers of their own, the rest ride the object
    broadcast)."""

    def __init__(self, model=None, optimizer=None, **kwargs):
        self._saved_model_state = None
        self._saved_optimizer_state = None
        super().__init__(bcast_object=broadcast_object, model=model,
                         optimizer=optimizer, **kwargs)
        # The model and the optimizer sync through their handlers below,
        # not as pickled objects.
        self._saved_state.pop("model", None)
        self._saved_state.pop("optimizer", None)

    def save(self):
        if self.model is not None:
            self._saved_model_state = copy.deepcopy(self.model.state_dict())
        if self.optimizer is not None:
            self._saved_optimizer_state = copy.deepcopy(
                self.optimizer.state_dict())
        super().save()

    def restore(self):
        if self.model is not None and self._saved_model_state is not None:
            self.model.load_state_dict(self._saved_model_state)
        if self.optimizer is not None and \
                self._saved_optimizer_state is not None:
            # A copy: load_state_dict keeps the state tensors it is given
            # when their device and dtype already match, and the next step
            # would then update the commit in place.
            self.optimizer.load_state_dict(
                copy.deepcopy(self._saved_optimizer_state))
        super().restore()

    def sync(self):
        if self.model is not None:
            broadcast_parameters(self.model.state_dict(), root_rank=0)
        if self.optimizer is not None:
            broadcast_optimizer_state(self.optimizer, root_rank=0)
        super().sync()


class ElasticSampler(torch.utils.data.Sampler):
    """Shards a dataset over the ranks and records the processed indices,
    so a resized job resumes mid-epoch without revisiting data (reference:
    torch/elastic/sampler.py:24-121)."""

    def __init__(self, dataset, shuffle=True, seed=0):
        self.dataset = dataset
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.processed_indices = set()
        self.reset()

    def set_epoch(self, epoch):
        self.epoch = epoch
        self.processed_indices = set()
        self.reset()

    def record_batch(self, batch_idx, batch_size):
        start = batch_idx * batch_size
        self.processed_indices |= set(self.indices[start:start + batch_size])

    def reset(self):
        """This rank's shard of the indices not processed yet: after
        ``set_epoch``, and after an elastic reset (rank and size may have
        changed)."""
        from horovod_tpu_torch.common import basics
        self.rank = basics.rank()
        self.num_replicas = basics.size()

        all_indices = [i for i in range(len(self.dataset))
                       if i not in self.processed_indices]
        if self.shuffle:
            g = torch.Generator()
            g.manual_seed(self.seed + self.epoch)
            perm = torch.randperm(len(all_indices), generator=g).tolist()
            all_indices = [all_indices[i] for i in perm]
        # Padded so every rank draws the same number of samples.
        total = len(all_indices)
        if total % self.num_replicas:
            pad = self.num_replicas - total % self.num_replicas
            all_indices += all_indices[:pad]
        self.num_samples = len(all_indices) // self.num_replicas
        self.indices = all_indices[self.rank::self.num_replicas]

    def state_dict(self):
        return {"epoch": self.epoch,
                "processed_indices": sorted(self.processed_indices)}

    def load_state_dict(self, state):
        self.epoch = state["epoch"]
        self.processed_indices = set(state["processed_indices"])
        self.reset()

    def __iter__(self):
        return iter(self.indices)

    def __len__(self):
        return self.num_samples
