"""The reparametrization sampler of a model stack (counterpart of
:mod:`trieste_tpu.models.stacks`)."""
from __future__ import annotations

from typing import Optional

import torch

from ..utils.misc import generator_for
from .interfaces import ModelStack, ReparametrizationSampler


class StackReparametrizationSampler(ReparametrizationSampler):
    """Samples of a :class:`ModelStack`: each member's own reparametrization sampler gives
    its slice of the outputs, and the slices concatenate on the last axis. At the first
    call the members freeze their base draws in order, from the one ``generator``."""

    def __init__(self, sample_size: int, stack: ModelStack):
        super().__init__(sample_size, stack)
        self._samplers = [m.reparam_sampler(sample_size) for m in stack.models]

    def sample(
        self, at: torch.Tensor, *, generator: Optional[torch.Generator] = None, **kwargs
    ) -> torch.Tensor:
        """``at [..., B, D]`` → ``[..., S, B, L]``; ``kwargs`` (a ``jitter``) go to every
        member."""
        if any(s._eps is None for s in self._samplers):
            generator = generator_for(generator, at.device)
        return torch.cat(
            [s.sample(at, generator=generator, **kwargs) for s in self._samplers], dim=-1
        )

    def reset_sampler(self) -> None:
        super().reset_sampler()
        for s in self._samplers:
            s.reset_sampler()
