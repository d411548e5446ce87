"""Jitted train / eval steps over a device mesh.

One compiled step does what the reference's hot loop does per iteration
(``pytorch/main_strong.py:346-406``): forward the weak batch and the
strong batch in train mode (SpecAugment / mixup / timeshift on-device),
mix the targets with the same lambdas, sum ``weak_clip_bce +
strong_frame_bce``, and take an AMSGrad step.  Under ``jit`` with the
batch sharded over the ``data`` mesh axis and parameters replicated, XLA
inserts the gradient all-reduce automatically — the replacement for
``torch.nn.DataParallel``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import jax
import jax.numpy as jnp

from sed_jax.augment import functional as aug
from sed_jax.ops import wire as wire_ops
from sed_jax.parallel import mesh as mesh_lib
from sed_jax.train.state import SedTrainState


class LossScaleState(NamedTuple):
    """Dynamic loss-scale state (jmp-style).

    bfloat16 shares float32's exponent range, so classic fp16 underflow
    scaling is not the point here — the value is the NONFINITE-STEP SKIP:
    a half-precision step whose gradients overflow/NaN
    (``Cnn_9layers_Transformer_FrameAtt`` has diverged within 30 bf16
    steps at lr 1e-3, tests/test_train_extra.py) leaves
    params/opt_state/batch_stats untouched and halves the scale instead
    of poisoning the run.
    """
    scale: jnp.ndarray          # current loss scale (f32 scalar)
    good_steps: jnp.ndarray     # consecutive finite steps (i32 scalar)


def init_loss_scale(initial: float = 2.0 ** 12) -> LossScaleState:
    return LossScaleState(scale=jnp.float32(initial),
                          good_steps=jnp.int32(0))


_GROWTH_INTERVAL = 200
_MAX_SCALE = 2.0 ** 15
_MIN_SCALE = 1.0


def _all_finite(tree) -> jnp.ndarray:
    leaves = [jnp.all(jnp.isfinite(x)) for x in jax.tree_util.tree_leaves(tree)]
    return jnp.stack(leaves).all() if leaves else jnp.bool_(True)


def _tree_select(pred, on_true, on_false):
    """Leafwise where(pred, a, b) preserving each leaf's dtype."""
    return jax.tree_util.tree_map(
        lambda a, b: jnp.where(pred, a, b), on_true, on_false)


def make_train_step(model, weak_loss_func: Callable,
                    strong_loss_func: Callable, mixup: bool,
                    timeshift: bool, spec_augment: bool,
                    mesh=None, donate: bool = True,
                    state_sharding=None,
                    loss_scale: Optional[Union[str, float]] = None,
                    wire_samples: Optional[int] = None):
    """Build a jitted joint weak+strong train step.

    Returns ``step(state, weak_batch, strong_batch, rng) ->
    (state, metrics)``.  Batch dicts: weak {'waveform', 'target'
    [, 'mixup_lambda']}, strong {'waveform', 'strong_target'
    [, 'mixup_lambda']}; an optional extra strong stream (FSD50K,
    ``pytorch/main_strong.py:238-247``) can be passed as
    ``strong_batch={'streams': [...]}`` — here we accept a list.

    ``loss_scale='dynamic'`` (recommended whenever the model computes in
    bfloat16) changes the signature to ``step(state, weak_batch,
    strong_batch, rng, scale_state) -> (state, metrics, scale_state)``:
    the loss is scaled, gradients unscaled, and a step whose gradients
    are nonfinite is SKIPPED (params/opt_state/batch_stats unchanged)
    while the scale halves; after 200 consecutive finite steps the scale
    doubles (capped 2^15).  Metrics gain ``grads_finite``/``loss_scale``.
    A float value fixes a static scale with the same skip behavior.
    """

    def _forward(params, batch_stats, batch, rng):
        variables = {'params': params}
        if batch_stats is not None:
            variables['batch_stats'] = batch_stats
        k1, k2 = jax.random.split(rng)
        lam = batch.get('mixup_lambda') if mixup else None
        # compressed wire batches (int16 PCM as-is from the HDF5, or
        # opt-in mu-law/qN from the loader's --train_wire) dequantize
        # on device, fused into the frontend, so fewer bytes cross
        # from host to device.
        # `wire_samples` names the decoded clip length for the
        # narrower-than-samples qN buffers (sed_jax/ops/wire.py).
        wav = wire_ops.dequant_wire(batch['waveform'], wire_samples)
        out, mutated = model.apply(
            variables, wav, train=True,
            mixup_lambda=lam, timeshift=timeshift,
            spec_augment=spec_augment,
            rngs={'dropout': k1, 'augment': k2},
            mutable=['batch_stats'])
        return out, mutated.get('batch_stats'), lam

    def loss_fn(params, batch_stats, weak_batch, strong_batches, rng):
        rngs = jax.random.split(rng, 1 + len(strong_batches))
        out_w, batch_stats, lam_w = _forward(params, batch_stats,
                                             weak_batch, rngs[0])
        target_w = weak_batch['target']
        if lam_w is not None:
            target_w = aug.do_mixup(target_w, lam_w)
        weak_loss = weak_loss_func(out_w, {'target': target_w})

        strong_loss = 0.0
        for batch, k in zip(strong_batches, rngs[1:]):
            out_s, batch_stats, lam_s = _forward(params, batch_stats,
                                                 batch, k)
            target_s = batch['strong_target']
            if lam_s is not None:
                target_s = aug.do_mixup(target_s, lam_s)
            strong_loss = strong_loss + strong_loss_func(
                out_s, {'strong_target': target_s})

        loss = weak_loss + strong_loss
        return loss, (batch_stats, weak_loss, strong_loss)

    def step(state: SedTrainState, weak_batch: dict, strong_batches,
             rng) -> tuple:
        if isinstance(strong_batches, dict):
            strong_batches = [strong_batches]
        grad_fn = jax.value_and_grad(loss_fn, has_aux=True)
        (loss, (batch_stats, weak_loss, strong_loss)), grads = grad_fn(
            state.params, state.batch_stats, weak_batch, strong_batches,
            rng)
        state = state.apply_gradients(grads=grads)
        state = state.replace(batch_stats=batch_stats)
        metrics = {'loss': loss, 'weak_loss': weak_loss,
                   'strong_loss': strong_loss}
        return state, metrics

    def scaled_step(state: SedTrainState, weak_batch: dict,
                    strong_batches, rng,
                    scale_state: LossScaleState) -> tuple:
        if isinstance(strong_batches, dict):
            strong_batches = [strong_batches]

        def scaled_loss(params, batch_stats, wb, sbs, r):
            loss, aux = loss_fn(params, batch_stats, wb, sbs, r)
            return loss * scale_state.scale, aux

        grad_fn = jax.value_and_grad(scaled_loss, has_aux=True)
        (sloss, (batch_stats, weak_loss, strong_loss)), grads = grad_fn(
            state.params, state.batch_stats, weak_batch, strong_batches,
            rng)
        inv = 1.0 / scale_state.scale
        grads = jax.tree_util.tree_map(
            lambda g: g.astype(jnp.float32) * inv, grads)
        finite = _all_finite(grads)
        stepped = state.apply_gradients(grads=jax.tree_util.tree_map(
            lambda g: jnp.where(finite, g, jnp.zeros_like(g)), grads))
        stepped = stepped.replace(batch_stats=batch_stats)
        # nonfinite step: keep EVERYTHING (params, opt_state, step count,
        # batch_stats) — the bad batch never happened
        state = _tree_select(finite, stepped, state)
        if dynamic:
            good = jnp.where(finite, scale_state.good_steps + 1,
                             jnp.int32(0))
            grow = good >= _GROWTH_INTERVAL
            new_scale = jnp.where(
                finite,
                jnp.where(grow,
                          jnp.minimum(scale_state.scale * 2.0, _MAX_SCALE),
                          scale_state.scale),
                jnp.maximum(scale_state.scale * 0.5, _MIN_SCALE))
            scale_state = LossScaleState(
                scale=new_scale,
                good_steps=jnp.where(grow, jnp.int32(0), good))
        metrics = {'loss': sloss * inv, 'weak_loss': weak_loss,
                   'strong_loss': strong_loss,
                   'grads_finite': finite,
                   'loss_scale': scale_state.scale}
        return state, metrics, scale_state

    dynamic = loss_scale == 'dynamic'
    if loss_scale is not None and not dynamic:
        # static scale, same 4-arg signature as the plain step, same
        # skip-on-nonfinite behavior
        fixed = float(loss_scale)

        def scaled_step_static(state, weak_batch, strong_batches, rng):
            ss = LossScaleState(scale=jnp.float32(fixed),
                                good_steps=jnp.int32(0))
            s, m, _ = scaled_step(state, weak_batch, strong_batches,
                                  rng, ss)
            return s, m

        fn = scaled_step_static
    else:
        fn = scaled_step if dynamic else step
    if mesh is not None:
        replicated = mesh_lib.replicated_sharding(mesh)
        sharded = mesh_lib.batch_sharding(mesh)
        # state_sharding (e.g. from parallel.mesh.fsdp_shardings) pins
        # parameter/optimizer shards; default is replicated params
        state_in = state_sharding if state_sharding is not None \
            else replicated
        in_sh = (state_in, sharded, sharded, replicated)
        out_sh = (state_in, replicated)
        if dynamic:
            in_sh = in_sh + (replicated,)
            out_sh = out_sh + (replicated,)
        return jax.jit(
            fn,
            in_shardings=in_sh,
            out_shardings=out_sh,
            donate_argnums=(0,) if donate else ())
    return jax.jit(fn, donate_argnums=(0,) if donate else ())


def make_eval_step(model):
    """Jitted eval forward returning the full output dict."""

    @jax.jit
    def step(params, batch_stats, waveform):
        variables = {'params': params}
        if batch_stats is not None:
            variables['batch_stats'] = batch_stats
        return model.apply(variables, waveform, train=False)

    return step
