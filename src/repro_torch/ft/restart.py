"""Checkpoint/restart driver: run a step function with periodic checkpoints,
resuming from the newest checkpoint after (injected or real) failures.

``run_with_restarts`` is deliberately synchronous and exception-driven: at
cluster scale the same loop runs under a scheduler that re-launches dead
jobs; determinism comes from the synthetic data pipeline being keyed by
step number, so a resumed run replays the exact batch sequence.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.ckpt import checkpoint as ck


def _to_devices(tree, like):
    """``tree`` (CPU tensors from ``ck.restore``) with each leaf on the
    device of ``like``'s leaf at the same place."""
    if isinstance(tree, dict):
        return {k: _to_devices(v, like[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_devices(v, w) for v, w in zip(tree, like)]
    if isinstance(like, torch.Tensor):
        return tree.to(like.device)
    return tree


def run_with_restarts(init_state_fn: Callable[[], dict],
                      step_fn: Callable[[dict, int], dict],
                      *, n_steps: int, ckpt_dir, ckpt_every: int = 10,
                      max_restarts: int = 10,
                      state_like_fn=None) -> tuple[dict, dict]:
    """Run ``n_steps``; on any exception, restore and continue.

    Returns (final_state, stats).  ``step_fn`` may raise (fault injection in
    tests, real device or host errors in production).  The state is a tree
    of tensors (``ckpt.checkpoint.save``'s); ``state_like_fn`` gives the
    tree a checkpoint is restored into (default ``init_state_fn``), whose
    dtypes and device the restored leaves take.
    """
    stats = {"restarts": 0, "completed": 0, "resumed_from": []}
    state = None
    step = 0
    restarts = 0
    while step < n_steps:
        try:
            if state is None:
                last = ck.latest_step(ckpt_dir)
                if last is not None:
                    like = (state_like_fn() if state_like_fn
                            else init_state_fn())
                    state = _to_devices(ck.restore(ckpt_dir, last, like),
                                        like)
                    step = last
                    stats["resumed_from"].append(last)
                else:
                    state = init_state_fn()
                    step = 0
            state = step_fn(state, step)
            step += 1
            stats["completed"] += 1
            if step % ckpt_every == 0:
                ck.save(ckpt_dir, step, state)
        except KeyboardInterrupt:
            raise
        except Exception:
            restarts += 1
            stats["restarts"] = restarts
            if restarts > max_restarts:
                raise
            state = None   # force restore on next iteration
    ck.save(ckpt_dir, step, state)
    return state, stats
