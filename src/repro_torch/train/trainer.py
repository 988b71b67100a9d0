"""Training loop (counterpart of ``repro.train.trainer``): a step with
microbatch accumulation, gradient clipping and the LR schedule, rolling
fault-tolerant checkpoints, auto-resume.

``make_train_step`` builds the step from any ``loss_fn(params, batch) ->
scalar`` over a tree of parameter tensors and a dict batch of tensors;
model-specific code stays in ``repro_torch.models``.  The step is
functional, as JAX's is: it returns a new state and leaves its argument
as it was.  Gradients are taken with autograd under
``torch.enable_grad()``, so the step also runs under ``torch.no_grad()``.

Sharded training (``Trainer(mesh=, param_specs=)``): the state lives on a
``(data, model)`` ``DeviceMesh`` as ``DTensor`` leaves, laid out by
:func:`state_shardings` (the Adam moments as the parameters, the step
replicated, as a plain 0-d tensor every rank holds), and the batches come
split over ``data`` (``ShardedBatchIterator(mesh=)``).  The step runs the
same code: the loss is reduced to its global value, and each gradient is
laid out as its parameter (the all-reduce over ``data``) before the
clip and the update.
"""

from __future__ import annotations

import time
from typing import Any, Callable, NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.device import resolve_device
from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     clip_by_global_norm)
from repro_torch.optim.schedules import linear_warmup_cosine
from repro_torch.train import checkpoint as ckpt
from repro_torch.utils.sharding import (NamedSharding, P, full_tensor,
                                        is_dtensor, replicate,
                                        specs_to_shardings, to_local,
                                        use_mesh)
from repro_torch.utils.tree import tree_flatten, tree_map, tree_unflatten

__all__ = ["TrainConfig", "TrainState", "value_and_grad", "make_train_step",
           "init_state", "state_shardings", "Trainer"]


class TrainConfig(NamedTuple):
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    microbatches: int = 1          # gradient accumulation factor
    opt_state_dtype: torch.dtype = torch.float32
    ckpt_every: int = 200
    keep_last: int = 3


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    step: torch.Tensor             # int32 []


def _laid_out_as(g, p):
    """A gradient laid out as its parameter: a partial sum over the ranks
    that split the batch is all-reduced here (a plain parameter, a 0-d
    one every rank holds, gets its gradient whole)."""
    if is_dtensor(p) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    if is_dtensor(g) and not is_dtensor(p):
        return full_tensor(g)
    return g


def value_and_grad(loss_fn: Callable, params: Any, batch: dict
                   ) -> tuple[torch.Tensor, Any]:
    """``(loss_fn(params, batch), its gradient in params)``, the gradient
    a tree like ``params`` (each sharded leaf's gradient laid out as the
    leaf); works under ``torch.no_grad()`` too.  The loss is a plain 0-d
    tensor: over a mesh, its global value, the same on every rank."""
    leaves, treedef = tree_flatten(params)
    with torch.enable_grad():
        live = [p.detach().requires_grad_(True) for p in leaves]
        loss = replicate(loss_fn(tree_unflatten(treedef, live), batch))
        grads = torch.autograd.grad(loss, live)
    grads = [_laid_out_as(g, p) for g, p in zip(grads, leaves)]
    return to_local(loss.detach()), tree_unflatten(treedef, grads)


def make_train_step(loss_fn: Callable, tc: TrainConfig, donate: bool = False):
    """Returns ``step(state, batch) -> (state, metrics)``; the metrics are
    plain 0-d tensors ``loss``, ``grad_norm`` (before clipping) and
    ``lr``.  With ``donate`` the step writes the new parameters and
    moments into ``state``'s tensors (the counterpart of JAX's buffer
    donation: the state it was given is consumed, and a step holds one
    copy of it, not two); without it ``state`` is left as it was."""
    sched = linear_warmup_cosine(tc.lr, tc.warmup_steps, tc.total_steps)

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        if tc.microbatches > 1:
            n = tc.microbatches
            micro = tree_map(
                lambda x: x.reshape((n, x.shape[0] // n) + x.shape[1:]), batch)
            loss = 0.0
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                             state.params)
            for i in range(n):
                mb_loss, mb_grads = value_and_grad(
                    loss_fn, state.params, tree_map(lambda x: x[i], micro))
                loss = loss + mb_loss
                grads = tree_map(torch.add, grads, mb_grads)
            loss = loss / n
            grads = tree_map(lambda g: g / n, grads)
        else:
            loss, grads = value_and_grad(loss_fn, state.params, batch)

        grads, gnorm = clip_by_global_norm(grads, tc.clip_norm)
        lr = sched(state.step)
        params, opt = adamw_update(grads, state.opt, state.params, lr=lr,
                                   weight_decay=tc.weight_decay,
                                   inplace=donate)
        new_state = TrainState(params, opt, state.step + 1)
        return new_state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return step


def init_state(generator: torch.Generator, init_params_fn: Callable,
               tc: TrainConfig) -> TrainState:
    """Fresh parameters from ``init_params_fn(generator)``, zero Adam
    moments in ``tc.opt_state_dtype`` and step 0, on the parameters'
    device."""
    params = init_params_fn(generator)
    opt = adamw_init(params, tc.opt_state_dtype)
    return TrainState(params, opt, torch.zeros((), dtype=torch.int32,
                                               device=opt.step.device))


def state_shardings(mesh: DeviceMesh, param_spec_tree: Any) -> TrainState:
    """Optimizer state shards exactly like params; step is replicated."""
    p = specs_to_shardings(mesh, param_spec_tree)
    return TrainState(
        params=p,
        opt=AdamWState(step=NamedSharding(mesh, P()), mu=p, nu=p),
        step=NamedSharding(mesh, P()),
    )


def _mesh_device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


class Trainer:
    """Orchestrates: auto-resume -> step loop -> rolling checkpoints.

    Every ``tc.ckpt_every`` steps the whole state and the data iterator's
    state are written atomically; on (re)start the newest readable
    checkpoint is restored onto ``device`` (the GPU unless the caller asks
    for the CPU), or, with a ``mesh``, onto the current mesh, whatever
    mesh saved it (elastic re-mesh).  ``crash_after`` is a test hook
    simulating preemption.  ``save_seconds`` holds the host time of each
    checkpoint save, and ``start_step`` the step the last ``fit`` started
    from (> 0 after a resume).

    ``mesh`` and ``param_specs`` (a tree of :class:`~repro_torch.utils.
    sharding.P` like the parameters; every leaf replicated without it)
    train on a ``(data, model)`` mesh of ranks; ``device`` is then this
    rank's device of the mesh, and only rank 0 prints.  ``donate`` (True
    by default, as in JAX) makes ``fit`` hand each step its state to
    consume: the step writes the new parameters and moments into the old
    state's tensors, and ``fit`` keeps no other reference to them, so the
    old values are freed as the new ones are written and a step holds one
    state, not two.
    """

    def __init__(self, loss_fn: Callable, init_params_fn: Callable,
                 tc: TrainConfig, *, ckpt_dir: str | None = None,
                 device: str | torch.device | None = None,
                 mesh: DeviceMesh | None = None,
                 param_specs: Any | None = None, donate: bool = True):
        self.tc = tc
        self.ckpt_dir = ckpt_dir
        self.mesh = mesh
        self.device = (resolve_device(device) if mesh is None
                       else _mesh_device(mesh))
        self.loss_fn = loss_fn
        self.init_params_fn = init_params_fn
        self.param_specs = param_specs
        self.shardings = (state_shardings(mesh, param_specs)
                          if mesh is not None and param_specs is not None
                          else None)
        self.step_fn = make_train_step(loss_fn, tc, donate=donate)
        self.save_seconds: list[float] = []
        self.start_step: int | None = None
        self._verbose = mesh is None or dist.get_rank() == 0

    def _log(self, msg: str) -> None:
        if self._verbose:
            print(msg)

    def _fresh_state(self, generator: torch.Generator) -> TrainState:
        if self.mesh is None:
            state = init_state(generator, self.init_params_fn, self.tc)
            return tree_map(lambda t: t.to(self.device), state)
        # every rank draws the whole parameters from the same generator
        # and keeps its own pieces; the moments are made sharded
        params = self.init_params_fn(generator)
        if self.shardings is None:
            leaves, treedef = tree_flatten(params)
            self.shardings = state_shardings(
                self.mesh, tree_unflatten(treedef, [P()] * len(leaves)))
        params = tree_map(lambda t, sh: sh.place(t), params,
                          self.shardings.params)
        opt = adamw_init(params, self.tc.opt_state_dtype)
        return TrainState(params, opt, torch.zeros(
            (), dtype=torch.int32, device=self.device))

    def init_or_resume(self, generator: torch.Generator, data_iter=None
                       ) -> TrainState:
        state = self._fresh_state(generator)
        if self.ckpt_dir:
            got = ckpt.restore_latest(self.ckpt_dir, state, self.shardings)
            if got is not None:
                state, extra, step = got
                if data_iter is not None and "data" in extra:
                    data_iter.load_state_dict(extra["data"])
                self._log(f"[trainer] resumed from step {step}")
        return state

    def _save(self, step: int, state: TrainState, data_iter) -> None:
        t0 = time.perf_counter()
        with use_mesh(self.mesh):
            ckpt.save(self.ckpt_dir, step, state,
                      extra={"data": data_iter.state_dict()},
                      keep_last=self.tc.keep_last)
        self.save_seconds.append(time.perf_counter() - t0)

    def fit(self, generator: torch.Generator, data_iter, n_steps: int,
            crash_after: int | None = None, log_every: int = 50
            ) -> tuple[TrainState, list[dict]]:
        state = self.init_or_resume(generator, data_iter)
        history = []
        start = self.start_step = int(state.step)
        t0 = time.time()
        for i in range(start, n_steps):
            batch = next(data_iter)
            with use_mesh(self.mesh):
                state, metrics = self.step_fn(state, batch)
            if (i + 1) % log_every == 0 or i == n_steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = i + 1
                m["wall_s"] = round(time.time() - t0, 2)
                history.append(m)
                self._log(f"[trainer] step {i+1}: loss={m['loss']:.4f} "
                          f"gnorm={m['grad_norm']:.3f}")
            if self.ckpt_dir and (i + 1) % self.tc.ckpt_every == 0:
                self._save(i + 1, state, data_iter)
            if crash_after is not None and (i + 1) >= crash_after:
                raise RuntimeError("simulated preemption")
        if self.ckpt_dir:
            self._save(n_steps, state, data_iter)
        return state, history
