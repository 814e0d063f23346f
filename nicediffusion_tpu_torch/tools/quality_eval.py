"""Self-contained sample-quality measurement for the lossy serving modes (torch).

Counterpart of the JAX package's tools/quality_eval.py, with its knobs, its
mode names and its JSON lines. No Inception weights are needed: the loop is
built locally.

  1. train the EMNIST-scale UNet (28x28x1, ch 64, mult 1/2/4, attention at
     7 and 14, AdaGN, 18.0M parameters) on the deterministic synthetic
     pipeline (training/data.py) through the port's ``Trainer``, with CFG
     label drop; labels live in 1..27, 0 is the null class; the EMA weights
     are kept;
  2. train an ``EncoderUNet`` classifier (adaptive pool, float32) on clean
     synthetic images with AdamW (optax's ``adamw(1e-3, weight_decay=1e-4)``);
  3. sample N images per serving mode, exact, encoder cache 2/3,
     limited-interval guidance, static int8 (calibrated) and their max
     stack, the DDIM and DPM-Solver++ controls and the distilled students,
     conditioned on cycling labels with identical draws: the chunk starting
     at row i of every mode is drawn from a ``torch.Generator`` seeded from
     (123, i);
  4. report per mode the classifier's accuracy against the conditioning
     label and the nearest-prototype accuracy (each with a standard error
     over chunks), the Frechet distance between the classifier-logit
     distributions of samples and real data (with a jackknife standard
     error), and the max and mean pixel deviation from the exact chain.

The UNet computes in bfloat16 on the CUDA card and in float32 on the CPU;
the classifier in float32. ``QE_DEVICE=cpu`` runs on the CPU (the
counterpart of the JAX tool's ``JAX_PLATFORMS``); without it and without a
card the tool raises.

Knobs (environment variables, the JAX tool's names and defaults):
  QE_TRAIN_STEPS=1500 QE_CLS_STEPS=1500 QE_EVAL_N=256 QE_BATCH=256
  QE_SAMPLE_STEPS=250 QE_CHUNK=256   sizes; accuracies are mean +/- s.e. over
                                     eval_n // chunk chunks
  QE_MODES=enc,gi,int8,distill,gdistill,pgdistill
                                     the lossy modes (exact always runs); also
                                     ddimctl (eta-0 and eta-1 DDIM controls on
                                     the exact teacher), dpmctl (DPM-Solver++
                                     rows at QE_DPM_STEPS, default 250,50,25)
                                     and stack (the int8 + enc2 + gi row, which
                                     also runs with int8 and gi)
  QE_ARCH=emnist|im64                the 28x28 EMNIST harness, or 64x64 with
                                     attention at 8/16/32
  QE_ENC_KS=2,3  QE_GI_W=1.0,1.5  QE_GI_BASE=1
                                     encoder-cache sweep; re-tuned guidance
                                     strengths inside the interval; 0 skips the
                                     preset-strength gi and stack rows
  QE_DISTILL=1 QE_DISTILL_STEPS=400  one unguided halving round (distill)
  QE_GDISTILL_STEPS QE_GDISTILL_PRED=eps|v QE_GDISTILL_VARW QE_GDISTILL_SAMPLE=1
  QE_PGDISTILL_STEPS QE_PGDISTILL_ROUNDS=1 QE_PGDISTILL_VARW
  QE_PGDISTILL_ETA1=1 QE_PGDISTILL_DDPM  guided distillation and the halving
                                     rounds on its student, with their DDIM,
                                     eta-1 and DDPM rows
  QE_CKPT, QE_GDISTILL_CKPT, QE_PGDISTILL_CKPT
                                     cache the trained weights as ``torch.save``
                                     files of the port's state dicts (a JAX
                                     cache is flax msgpack, which the port does
                                     not read)

A variance weight of 0 (``QE_GDISTILL_VARW=0``, ``QE_PGDISTILL_VARW=0``) is
off, as the port's distillers read it: it turns no DDPM row on and labels
none "vlb-trained".

Usage:
  python -m nicediffusion_tpu_torch.tools.quality_eval
  QE_TRAIN_STEPS=200 QE_EVAL_N=64 python -m nicediffusion_tpu_torch.tools.quality_eval
  QE_DEVICE=cpu QE_TRAIN_STEPS=2 QE_CLS_STEPS=2 QE_EVAL_N=8 QE_BATCH=8 \\
      QE_SAMPLE_STEPS=4 QE_MODES=enc,gi,int8 python -m nicediffusion_tpu_torch.tools.quality_eval
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

from ..diffusion.process import Diffusion
from ..models.classifier import EncoderUNet
from ..models.unet import DiffusionModel
from ..training.data import synthetic_batches
from ..training.trainer import Trainer
from ..utils.device import resolve_device

NUM_CLASSES = 28  # 27 letter classes + null class 0

DIFF_TRAIN_ARGS = dict(
    original_num_steps=1000, rescaled_num_steps=1000,
    beta_schedule="cosine", sampling_var_type="learned_interpolation",
    loss_type="hybrid", guidance_method="classifier_free",
    guidance_strength=0.8,
)


def arch_config(arch: str = "emnist") -> tuple[int, dict, dict]:
    """(resolution, the UNet's config, the classifier's config) of a harness
    architecture: ``emnist``, the reference EMNIST shapes, or ``im64``, 64x64
    with attention at 8/16/32 like the ImageNet-64 preset at a
    harness-trainable width (ch 64, 2 blocks)."""
    if arch == "emnist":
        res = 28
        model_cfg = dict(
            resolution=28, in_channels=1, model_channels=64, out_channels=2,
            num_res_blocks=2, attention_resolutions=(7, 14), channel_mult=(1, 2, 4),
            num_heads=4, num_classes=NUM_CLASSES, dropout=0.05,
            use_adaptive_gn=True, resblock_updown=True, split_qkv_first=True,
        )
    elif arch == "im64":
        res = 64
        model_cfg = dict(
            resolution=64, in_channels=1, model_channels=64, out_channels=2,
            num_res_blocks=2, attention_resolutions=(8, 16, 32),
            channel_mult=(1, 2, 3, 4), num_head_channels=32,
            num_classes=NUM_CLASSES, dropout=0.0,
            use_adaptive_gn=True, resblock_updown=True, split_qkv_first=False,
        )
    else:
        raise ValueError(f"unknown QE_ARCH {arch!r} (emnist | im64)")
    cls_cfg = dict(
        resolution=res, in_channels=1, model_channels=32, out_channels=NUM_CLASSES,
        num_res_blocks=1, attention_resolutions=(7,) if arch == "emnist" else (8,),
        channel_mult=(1, 2), num_heads=2, pool="adaptive",
    )
    return res, model_cfg, cls_cfg


def shifted_synthetic(batch_size: int, seed: int = 0, resolution: int = 28):
    """Synthetic batches with labels shifted to 1..27 (0 = CFG null).

    num_distinct=512 gives ~19 images per class, so the classifier learns
    the class signatures rather than the individual pool images (it is
    evaluated on a different seed's pool)."""
    gen = synthetic_batches(batch_size=batch_size, resolution=resolution, channels=1,
                            num_classes=27, seed=seed, num_distinct=512)
    for x, y in gen:
        yield x, y + 1


def _var_weight(name: str) -> float | None:
    """A variance-weight knob: unset, empty or 0 is off (None)."""
    value = os.environ.get(name)
    return (float(value) if value else None) or None


def train_unet(steps: int, batch: int, dtype, device, model_cfg: dict, resolution: int,
               seed: int = 0):
    """``steps`` Trainer steps of the UNet; returns the Trainer's EMA model."""
    torch.manual_seed(seed)
    model = DiffusionModel(**model_cfg, dtype=dtype, device=device)
    trainer = Trainer(
        model=model,
        diffusion_args=dict(DIFF_TRAIN_ARGS),
        dataloader=shifted_synthetic(batch, resolution=resolution),
        iterations=steps,
        batch_size=batch,
        lr=1.6e-4,
        weight_decay=1e-3,
        checkpoint_dir="qe_ckpts",  # never written: no save is asked for
        save_every=None,
        print_every=max(steps // 5, 1),
        label_drop_prob=0.02,
        seed=seed,
    )
    for step in range(steps):
        b, y = next(trainer.loader)
        metrics = trainer.train_step(b, y)
        if step % max(steps // 5, 1) == 0:
            print(f"  unet step {step}: loss={metrics['loss'].item():.4f}")
    return trainer.ema_model


def train_classifier(steps: int, batch: int, device, cls_cfg: dict, resolution: int,
                     seed: int = 5, init_state=None):
    """``steps`` AdamW steps (optax's ``adamw(1e-3, weight_decay=1e-4)``) of
    the classifier on softmax cross-entropy, from ``init_state`` (a state
    dict) or a seeded init. As the JAX tool, the first batch of the stream
    is the init's example and is not trained on. Returns the model."""
    torch.manual_seed(seed)
    model = EncoderUNet(**cls_cfg, device=device)
    if init_state is not None:
        model.load_state_dict(init_state, strict=True)
    gen = shifted_synthetic(batch, seed=1, resolution=resolution)
    next(gen)
    # lr 1e-3 / >=1200 steps: measured 0.85 held-out (cross-seed) accuracy
    # on the synthetic classes; 3e-4/600 plateaued near chance
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    zeros = torch.zeros((batch,), dtype=torch.long, device=device)
    model.train()
    acc = torch.zeros(())
    for i in range(steps):
        x, y = next(gen)
        x = torch.as_tensor(x, device=device)
        y = torch.as_tensor(y, dtype=torch.long, device=device)
        logits = model(x, zeros[:x.shape[0]])
        loss = F.cross_entropy(logits, y)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        acc = (logits.argmax(-1) == y).float().mean()
        if i % max(steps // 5, 1) == 0:
            print(f"  cls step {i}: loss={loss.item():.4f} acc={acc.item():.3f}")
    print(f"  cls final train acc={acc.item():.3f}")
    return model.eval().requires_grad_(False)


def frechet(feat_a, feat_b) -> float:
    """Frechet distance between Gaussians fit to two feature sets."""
    mu_a, mu_b = feat_a.mean(0), feat_b.mean(0)
    cov_a = np.cov(feat_a, rowvar=False)
    cov_b = np.cov(feat_b, rowvar=False)
    diff = mu_a - mu_b
    # sqrtm via the eigenvalues of the product
    prod = cov_a @ cov_b
    eigs = np.linalg.eigvals(prod)
    covmean_tr = np.sqrt(np.clip(eigs.real, 0, None)).sum()
    return float(diff @ diff + np.trace(cov_a) + np.trace(cov_b) - 2.0 * covmean_tr)


def chunk_seed(base: int, row: int) -> int:
    """The seed of the chunk that starts at ``row`` (the counterpart of
    ``jax.random.fold_in(PRNGKey(base), row)``)."""
    return int(np.random.SeedSequence([base, row]).generate_state(1)[0])


def sample_mode(diffusion, y_eval, enc_cache=None, gi=None) -> np.ndarray:
    """The chain of every label of ``y_eval`` through ``diffusion``, f32
    NHWC, in chunks of up to 128 rows; each chunk drawn from a generator of
    its own, seeded from 123 and its first row (``chunk_seed``)."""
    eval_n = int(y_eval.shape[0])
    outs = []
    per = min(eval_n, 128)
    for i in range(0, eval_n, per):
        labels = y_eval[i:i + per]  # the final slice may be short
        g = torch.Generator(device=y_eval.device).manual_seed(chunk_seed(123, i))
        outs.append(diffusion.denoise(g, y=labels, batch_size=int(labels.shape[0]),
                                      encoder_cache=enc_cache,
                                      guidance_interval=gi).float().cpu().numpy())
    return np.concatenate(outs, 0)


def _load(path, device):
    return torch.load(path, map_location=device, weights_only=True)


def main(argv: list[str] | None = None) -> int:
    """Run the harness as the knobs say (environment variables, as in the
    JAX tool; ``argv`` takes only ``--help``); prints one JSON line per mode
    and returns 0."""
    argparse.ArgumentParser(prog="nicediffusion_tpu_torch.tools.quality_eval",
                            description=__doc__,
                            formatter_class=argparse.RawDescriptionHelpFormatter
                            ).parse_args(argv)
    train_steps = int(os.environ.get("QE_TRAIN_STEPS", 1500))
    cls_steps = int(os.environ.get("QE_CLS_STEPS", 1500))
    eval_n = int(os.environ.get("QE_EVAL_N", 256))
    batch = int(os.environ.get("QE_BATCH", 256))
    sample_steps = int(os.environ.get("QE_SAMPLE_STEPS", 250))
    res, model_cfg, cls_cfg = arch_config(os.environ.get("QE_ARCH", "emnist"))
    device = resolve_device("cpu" if os.environ.get("QE_DEVICE") == "cpu" else None,
                            ask="set QE_DEVICE=cpu")
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    print(f"device={device.type} train_steps={train_steps} eval_n={eval_n}")

    def synthetic(b, seed=0):
        return shifted_synthetic(b, seed, res)

    ckpt_path = os.environ.get("QE_CKPT")
    if ckpt_path and os.path.exists(ckpt_path):
        print(f"reusing trained weights from {ckpt_path}...")
        restored = _load(ckpt_path, device)
        model = DiffusionModel(**model_cfg, dtype=dtype, device=device)
        model.load_state_dict(restored["ema"], strict=True)
        cls_model = EncoderUNet(**cls_cfg, device=device)
        cls_model.load_state_dict(restored["cls"], strict=True)
    else:
        print("training UNet on synthetic data...")
        model = train_unet(train_steps, batch, dtype, device, model_cfg, res)
        print("training classifier...")
        cls_model = train_classifier(cls_steps, batch, device, cls_cfg, res)
        if ckpt_path:
            torch.save({"ema": model.state_dict(), "cls": cls_model.state_dict()}, ckpt_path)
            print(f"saved trained weights to {ckpt_path}")
    model.eval().requires_grad_(False)
    cls_model.eval().requires_grad_(False)

    def logits_np(images, per=256):
        """Classifier logits in fixed-size chunks, the tail zero-padded to
        ``per``."""
        images = np.asarray(images, dtype=np.float32)
        out = []
        for i in range(0, len(images), per):
            part = images[i:i + per]
            n = len(part)
            if n < per:
                part = np.concatenate([part, np.zeros((per - n, *part.shape[1:]), part.dtype)])
            x = torch.as_tensor(part, device=device)
            with torch.inference_mode():
                lg = cls_model(x, torch.zeros((per,), dtype=torch.long, device=device))
            out.append(lg.float().cpu().numpy()[:n])
        return np.concatenate(out, 0)

    # sampling diffusion: the forced DDPM chain of Trainer.sample
    samp_args = dict(DIFF_TRAIN_ARGS, rescaled_num_steps=min(sample_steps, 1000))
    y_np = (np.arange(eval_n) % 27) + 1
    y_eval = torch.as_tensor(y_np, dtype=torch.long, device=device)

    def sample(diffusion, enc_cache=None, gi=None):
        return sample_mode(diffusion, y_eval, enc_cache, gi)

    wanted = set(os.environ.get("QE_MODES", "enc,gi,int8,distill,gdistill,pgdistill").split(","))
    modes = {}
    exact_diff = Diffusion(model=model, **samp_args)
    print("sampling: exact...")
    modes["exact"] = sample(exact_diff)
    if "enc" in wanted:
        enc_ks = [int(k) for k in os.environ.get("QE_ENC_KS", "2,3").split(",") if k]
        print(f"sampling: encoder_cache {enc_ks}...")
        for k in enc_ks:
            modes[f"enc{k}"] = sample(exact_diff, enc_cache=k)
    if "ddimctl" in wanted:
        # deterministic-DDIM controls on the exact teacher, CFG intact: the
        # sampler-regime control for the distilled students' DDIM rows
        n_full = samp_args["rescaled_num_steps"]
        for name, over in (
            (f"exact_ddim{n_full}", dict(use_ddim=True, ddim_eta=0.0)),
            (f"exact_ddim{n_full // 2}",
             dict(use_ddim=True, ddim_eta=0.0, rescaled_num_steps=n_full // 2)),
            (f"exact_ddim{n_full}_eta1", dict(use_ddim=True, ddim_eta=1.0)),
        ):
            print(f"sampling: {name} (CFG teacher, DDIM control)...")
            modes[name] = sample(Diffusion(model=model, **dict(samp_args, **over)))
    if "dpmctl" in wanted:
        dpm_steps = [int(s) for s in os.environ.get("QE_DPM_STEPS", "250,50,25").split(",")
                     if s]
        for n_dpm in dpm_steps:
            name = f"exact_dpmpp{n_dpm}"
            print(f"sampling: {name} (CFG teacher, DPM-Solver++ 2M)...")
            modes[name] = sample(Diffusion(model=model, **dict(
                samp_args, sampler="dpm++", rescaled_num_steps=n_dpm)))

    gi_w = [float(w) for w in os.environ.get("QE_GI_W", "").split(",") if w]
    gi_base = os.environ.get("QE_GI_BASE", "1") == "1"
    if "gi" in wanted:
        if gi_base:
            print("sampling: guidance_interval (0.1, 0.7) / (0.15, 0.55)...")
            modes["gi_0.1-0.7"] = sample(exact_diff, gi=(0.1, 0.7))
            modes["gi_0.15-0.55"] = sample(exact_diff, gi=(0.15, 0.55))
        # the guidance strength re-tuned inside the interval (arXiv:2404.07724)
        for w in gi_w:
            print(f"sampling: gi (0.1, 0.7) at re-tuned w={w}...")
            dw = Diffusion(model=model, **dict(samp_args, guidance_strength=w))
            modes[f"gi_0.1-0.7_w{w}"] = sample(dw, gi=(0.1, 0.7))

    if "int8" in wanted:
        print("sampling: int8-static (calibrated)...")
        from ..ops.quant import build_int8_variables, calibration_inputs

        model_q = DiffusionModel(**model_cfg, dtype=dtype, quantized=True, device=device).eval()
        model_q.load_state_dict(model.state_dict(), strict=True)
        diff_q = Diffusion(model=model_q, **samp_args)
        build_int8_variables(model_q, calibration_inputs(
            diff_q, torch.Generator(device=device).manual_seed(77), y=y_eval[:8],
            batch_size=8))
        modes["int8"] = sample(diff_q)
        if "stack" in wanted or "gi" in wanted:
            # every lossy lever composed: int8 static + encoder_cache 2 +
            # limited-interval guidance 0.1-0.7
            if gi_base:
                print("sampling: max stack (int8 + enc_cache 2 + gi 0.1-0.7)...")
                modes["stack_int8_enc2_gi"] = sample(diff_q, enc_cache=2, gi=(0.1, 0.7))
            for w in gi_w:
                print(f"sampling: max stack at re-tuned w={w}...")
                dqw = Diffusion(model=model_q, **dict(samp_args, guidance_strength=w))
                modes[f"stack_int8_enc2_gi_w{w}"] = sample(dqw, enc_cache=2, gi=(0.1, 0.7))
        del model_q, diff_q

    def student_of(teacher):
        """A fresh copy of ``teacher`` for a distiller to train in place."""
        return copy.deepcopy(teacher).requires_grad_(True)

    if "distill" in wanted and os.environ.get("QE_DISTILL", "1") == "1":
        # one unguided progressive-distillation round, 250 -> 125 (the
        # distillers strip guidance): the student's own fidelity
        from ..training.distill import ProgressiveDistiller

        print("distilling one round (250 -> 125, unguided)...")
        d_steps = int(os.environ.get("QE_DISTILL_STEPS", 400))
        distiller = ProgressiveDistiller(
            student_of(model), None, dict(DIFF_TRAIN_ARGS, rescaled_num_steps=250),
            synthetic(batch, seed=3), iterations=d_steps, lr=1e-4,
            lr_schedule="warmup_cosine")
        _, student_diff = distiller.run(log_every=max(d_steps // 4, 1))
        modes["distill125_unguided"] = sample(student_diff)
        del distiller, student_diff

    if "gdistill" in wanted:
        # stage-1 guided distillation (arXiv:2210.03142): w = 0.8 CFG baked
        # into one conditional forward, sampled on the exact row's DDPM chain
        from ..training.distill import GuidedDistiller

        gsteps = int(os.environ.get("QE_GDISTILL_STEPS", os.environ.get("QE_DISTILL_STEPS", 400)))
        base_steps = samp_args["rescaled_num_steps"]
        g_ckpt = os.environ.get("QE_GDISTILL_CKPT")
        g_pred = os.environ.get("QE_GDISTILL_PRED", "eps")
        g_tag = "v" if g_pred == "v" else ""
        gd = GuidedDistiller(
            student_of(model), None, dict(DIFF_TRAIN_ARGS, rescaled_num_steps=base_steps),
            synthetic(batch, seed=4), iterations=gsteps, guidance_strength=0.8, lr=1e-4,
            lr_schedule="warmup_cosine",
            student_prediction_type="v" if g_pred == "v" else None,
            var_weight=_var_weight("QE_GDISTILL_VARW"))
        if g_ckpt and os.path.exists(g_ckpt):
            print(f"reusing guided-distilled student from {g_ckpt}...")
            gd.model.load_state_dict(_load(g_ckpt, device), strict=True)
        else:
            print(f"guided distillation ({gsteps} steps, w=0.8 -> 1 fwd/step)...")
            gd.run(log_every=max(gsteps // 8, 1))
            if g_ckpt:
                torch.save(gd.model.state_dict(), g_ckpt)
                print(f"saved guided-distilled student to {g_ckpt}")
        g_student = gd.model.eval().requires_grad_(False)
        g_diff = gd.student
        if os.environ.get("QE_GDISTILL_SAMPLE", "1") == "1":
            modes[f"gdistill{g_tag}{base_steps}_1fwd"] = sample(g_diff)
            # the student with the other quality-neutral lever
            modes[f"gdistill{g_tag}{base_steps}_1fwd_enc2"] = sample(g_diff, enc_cache=2)

    if "pgdistill" in wanted:
        # stage 2 on stage 1: halve the guided (already unguided) student's
        # chain; gdistill*_ddim is the matched control (the same weights,
        # DDIM eta 0 on the unhalved grid)
        if "gdistill" not in wanted:
            print("pgdistill needs gdistill in QE_MODES; skipping")
        else:
            from ..training.distill import ProgressiveDistiller

            unguided = dict(samp_args, guidance_method=None, guidance_strength=None,
                            prediction_type=g_pred)
            gd_ddim = Diffusion(model=g_student, **dict(unguided, use_ddim=True, ddim_eta=0.0))
            print(f"sampling: gdistill{g_tag}{base_steps}_ddim control...")
            modes[f"gdistill{g_tag}{base_steps}_ddim"] = sample(gd_ddim)

            psteps = int(os.environ.get("QE_PGDISTILL_STEPS", gsteps))
            p_ckpt = os.environ.get("QE_PGDISTILL_CKPT")
            rounds = int(os.environ.get("QE_PGDISTILL_ROUNDS", 1))
            p_varw = _var_weight("QE_PGDISTILL_VARW")
            p_diff = None
            # chained rounds: round r+1's teacher grid is the previous
            # student's nested grid (timestep_indices)
            t_model = g_student
            t_args = dict(DIFF_TRAIN_ARGS, rescaled_num_steps=base_steps,
                          prediction_type=g_pred)
            for r in range(1, rounds + 1):
                n_t = t_args["rescaled_num_steps"]
                if n_t % 2:
                    print(f"pgdistill round {r}: cannot halve odd step count {n_t}; "
                          f"stopping at round {r - 1}")
                    break
                pd = ProgressiveDistiller(
                    student_of(t_model), None, t_args, synthetic(batch, seed=4 + r),
                    iterations=psteps, lr=1e-4, lr_schedule="warmup_cosine",
                    var_weight=p_varw)
                # round 1 keeps the bare QE_PGDISTILL_CKPT path; later
                # rounds suffix .r{r}
                ck = p_ckpt if (p_ckpt and r == 1) else (f"{p_ckpt}.r{r}" if p_ckpt else None)
                if ck and os.path.exists(ck):
                    print(f"reusing round-{r} progressive student from {ck}...")
                    pd.model.load_state_dict(_load(ck, device), strict=True)
                else:
                    print(f"progressive distillation round {r}/{rounds} "
                          f"({psteps} steps, {n_t} -> {n_t // 2})...")
                    pd.run(log_every=max(psteps // 8, 1))
                    if ck:
                        torch.save(pd.model.state_dict(), ck)
                        print(f"saved round-{r} progressive student to {ck}")
                t_model = pd.model.eval().requires_grad_(False)
                p_diff = pd.student
                n_s = p_diff.rescaled_num_steps
                modes[f"pgdistill{g_tag}{n_s}_1fwd"] = sample(p_diff)
                if r == rounds:  # the serving-stack bound only for the final student
                    modes[f"pgdistill{g_tag}{n_s}_1fwd_enc2"] = sample(p_diff, enc_cache=2)
                t_args = dict(DIFF_TRAIN_ARGS, rescaled_num_steps=n_s,
                              timestep_indices=p_diff.timestep_map.cpu().numpy(),
                              prediction_type=g_pred)
            if p_diff is not None:
                n_s = p_diff.rescaled_num_steps
                on_grid = dict(unguided, rescaled_num_steps=n_s,
                               timestep_indices=p_diff.timestep_map.cpu().numpy())
            ddpm_default = "1" if p_varw is not None else "0"
            if p_diff is not None and os.environ.get("QE_PGDISTILL_DDPM", ddpm_default) == "1":
                # stochastic DDPM on the student's nested grid: the variance
                # head is the teacher's unless QE_PGDISTILL_VARW trained it
                pd_ddpm = Diffusion(model=t_model, **on_grid)
                var_src = "vlb-trained" if p_varw is not None else "teacher-inherited"
                print(f"sampling: pgdistill{g_tag}{n_s}_ddpm (stochastic, {var_src} "
                      "variance head)...")
                modes[f"pgdistill{g_tag}{n_s}_ddpm"] = sample(pd_ddpm)
                modes[f"pgdistill{g_tag}{n_s}_ddpm_enc2"] = sample(pd_ddpm, enc_cache=2)
            if p_diff is not None and os.environ.get("QE_PGDISTILL_ETA1", "1") == "1":
                # stochastic DDIM (eta 1): schedule-derived noise, no learned
                # variance; gdistill*_eta1 is the matched unhalved control
                g_eta1 = Diffusion(model=g_student,
                                   **dict(unguided, use_ddim=True, ddim_eta=1.0))
                print(f"sampling: gdistill{g_tag}{base_steps}_eta1 control...")
                modes[f"gdistill{g_tag}{base_steps}_eta1"] = sample(g_eta1)
                pd_eta1 = Diffusion(model=t_model, **dict(on_grid, use_ddim=True, ddim_eta=1.0))
                print(f"sampling: pgdistill{g_tag}{n_s}_eta1 (stochastic DDIM, "
                      "schedule-derived noise)...")
                modes[f"pgdistill{g_tag}{n_s}_eta1"] = sample(pd_eta1)
                modes[f"pgdistill{g_tag}{n_s}_eta1_enc2"] = sample(pd_eta1, enc_cache=2)

    report(modes, logits_np, y_np, eval_n, synthetic)
    return 0


def report(modes: dict, logits_np, y_eval, eval_n: int, synthetic) -> dict:
    """The statistics of every mode's samples against a real-data draw, one
    JSON line per mode (the JAX tool's keys), then the chunk layout and the
    real data's own line; returns ``{mode: numbers}``."""
    gen = synthetic(eval_n, seed=9)
    x_real, y_real = next(gen)
    real_logits = logits_np(x_real)

    # pixel-space class prototypes from real data: nearest-prototype accuracy
    # is classifier-free evidence that the conditioning carries through
    protos = np.stack([
        x_real[np.asarray(y_real) == c].mean(0).ravel()
        if (np.asarray(y_real) == c).any() else np.zeros(x_real[0].size)
        for c in range(1, 28)
    ])

    def proto_dists(images):
        """[N, 27] squared distances to the class prototypes, via the
        matmul identity."""
        flat = images.reshape(len(images), -1).astype(np.float64)
        return (flat ** 2).sum(1)[:, None] - 2.0 * flat @ protos.T + (protos ** 2).sum(1)[None]

    # eval_n samples in k = eval_n // chunk chunks (each drawn under its own
    # seed): mean +/- s.e. over chunks
    chunk = min(int(os.environ.get("QE_CHUNK", 256)), eval_n)
    k = eval_n // chunk
    n_stat = k * chunk  # chunk statistics ignore any ragged remainder

    def acc_stats(correct):
        """(full-set acc, s.e. of the mean over k chunks)."""
        full = float(correct.mean())
        if k < 2:
            return full, None
        accs = np.asarray([correct[i * chunk:(i + 1) * chunk].mean() for i in range(k)])
        return full, float(accs.std(ddof=1) / np.sqrt(k))

    def frechet_jackknife(lg):
        """(full-set Frechet, leave-one-chunk-out jackknife s.e.)."""
        fd = frechet(lg, real_logits)
        if k < 2:
            return fd, None
        fds = []
        for i in range(k):
            mask = np.ones(len(lg), bool)
            mask[i * chunk:(i + 1) * chunk] = False
            fds.append(frechet(lg[mask], real_logits))
        fds = np.asarray(fds)
        return fd, float(np.sqrt((k - 1) / k * ((fds - fds.mean()) ** 2).sum()))

    def rounded(x, nd=4):
        return None if x is None else round(x, nd)

    results = {}
    for name, samples in modes.items():
        # a diverged mode must not abort the report: record its non-finite
        # fraction and skip the statistics that need finite samples
        finite = np.isfinite(samples).all(axis=tuple(range(1, samples.ndim)))
        nonfinite_frac = float(1.0 - finite.mean())
        if nonfinite_frac > 0:
            print(json.dumps({
                "mode": name, "nonfinite_sample_frac": round(nonfinite_frac, 4),
                "note": "samples diverged; finiteness-requiring stats skipped",
            }))
            results[name] = {"nonfinite_sample_frac": nonfinite_frac}
            continue
        lg = logits_np(samples)
        acc, acc_se = acc_stats(lg.argmax(-1) == y_eval)
        fd, fd_se = frechet_jackknife(lg)
        p_acc, p_se = acc_stats(proto_dists(samples).argmin(1) + 1 == y_eval)
        dev = np.abs(samples - modes["exact"])
        results[name] = {
            "classifier_acc": round(acc, 4),
            "classifier_acc_se": rounded(acc_se),
            "proto_acc": round(p_acc, 4),
            "proto_acc_se": rounded(p_se),
            "logit_frechet_vs_real": round(fd, 4),
            "logit_frechet_se": rounded(fd_se, 2),
            "max_pixel_dev_vs_exact": round(float(dev.max()), 4),
            "mean_pixel_dev_vs_exact": round(float(dev.mean()), 5),
        }
        print(json.dumps({"mode": name, **results[name]}))
    if k >= 2:
        print(json.dumps({"stats": {"eval_n": eval_n, "chunks": k, "chunk_size": chunk,
                                    "n_in_chunk_stats": n_stat}}))

    real_acc = float((real_logits.argmax(-1) == np.asarray(y_real)).mean())
    real_proto = float((proto_dists(x_real).argmin(1) + 1 == np.asarray(y_real)).mean())
    print(json.dumps({"mode": "real_data", "classifier_acc": round(real_acc, 4),
                      "proto_acc": round(real_proto, 4), "logit_frechet_vs_real": 0.0}))
    return results


if __name__ == "__main__":
    sys.exit(main())
