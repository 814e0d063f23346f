"""EMNIST training entry point (torch; one device, or one process per GPU).

Counterpart of scripts/train.py of the JAX package: the same hard-coded
recipe (EMNIST preset, batch 468, lr 1.6e-4, wd 1e-3, 1500 iterations, grad
checkpointing, classifier-free null class), every hyperparameter
overridable through the shared 'diff_train' CLI (utils/cli.py), and a
synthetic dataset standing in when the EMNIST files are absent. It trains
on the CUDA card unless ``--device`` says otherwise. Without ``--use_fp16``
the compute is f32 throughout: the script turns TF32 off in cuDNN and
cuBLAS, as the hand-written kernels' f32 paths use none.

Data-parallel over several GPUs, as the JAX script over every local device:
launched by torchrun, it joins the process group first
(parallel/multihost.py: NCCL for the gradients, gloo for host tensors) and
trains on ``cuda:LOCAL_RANK`` with ``Trainer(distributed=True)``;
``--batch_size`` stays the global batch, each process loads its
``batch_size // world`` rows with its rank as the loader's seed, and rank 0
alone writes checkpoints, metrics and samples. Without torchrun's
environment nothing of this runs.

NOTE on num_classes: the reference inconsistently trains with 28 classes
(train.py:39-40 adds the null class to 27) but samples with 27
(default_args.py:10). We train with the same 27+1=28; sampling such a
checkpoint needs num_classes=28.

Usage: python -m nicediffusion_tpu_torch.scripts.train [--synthetic]
           [--iterations N] [--batch_size B] [--use_fp16] [--device cuda] ...
       python -m torch.distributed.run --nproc_per_node N \\
           -m nicediffusion_tpu_torch.scripts.train [same flags]
"""

from __future__ import annotations

import os

# reference scripts/train.py:24-36 hard-coded recipe
DEFAULTS = dict(
    batch_size=468,
    lr=1.6e-4,
    weight_decay=1e-3,
    iterations=1500,
    save_every=100,
    print_every=10,
    grad_accumulation=1,
)


def main(argv: list[str] | None = None):
    """Parse ``argv`` (default: the command line), build the model and the
    Trainer, train, and return the Trainer."""
    import torch

    from ..models.unet import DiffusionModel
    import torch.distributed

    from ..parallel import backend_for, maybe_initialize_distributed, process_local_batch_size
    from ..parallel import rank as dp_rank
    from ..parallel import world as dp_world
    from ..training.data import emnist_batches, synthetic_batches
    from ..training.trainer import Trainer
    from ..utils.cli import make_argparser
    from ..utils.config import DIFFUSION_PRESETS, MODEL_PRESETS
    from ..utils.device import resolve_device
    from ..utils.image import save_image

    parser = make_argparser("diff_train")
    parser.set_defaults(
        batch_size=DEFAULTS["batch_size"],
        lr=DEFAULTS["lr"],
        weight_decay=DEFAULTS["weight_decay"],
        iterations=DEFAULTS["iterations"],
        save_every=DEFAULTS["save_every"],
        grad_accumulation=DEFAULTS["grad_accumulation"],
    )
    # the training parser marks these required; defaults satisfy them
    for action in parser._actions:
        if action.dest in DEFAULTS or action.dest in (
            "resolution", "model_channels", "channel_mult", "num_res_blocks",
            "attention_resolutions", "dropout", "rescaled_num_steps",
            "beta_schedule", "sampling_var_type", "loss_type",
        ):
            action.required = False
    parser.add_argument(
        "--synthetic", action="store_true", default=False,
        help="use the synthetic dataset instead of EMNIST",
    )
    parser.add_argument("--data_root", type=str, default="data/EMNIST/raw")
    parser.add_argument("--print_every", type=int, default=DEFAULTS["print_every"])
    parser.add_argument(
        "--no_grad_checkpoint", action="store_true", default=False,
        help="disable activation rematerialisation (the reference trains "
             "with grad checkpointing, train.py:42; it trades a second "
             "forward of every block for activation memory)",
    )
    parser.add_argument("--checkpoint_dir", type=str, default="checkpoints")
    parser.add_argument("--metrics_path", type=str, default="metrics.jsonl")
    parser.add_argument("--samples_dir", type=str, default="samples")
    args = parser.parse_args(argv)

    # under torchrun: join the group before the first device use
    maybe_initialize_distributed()
    distributed = torch.distributed.is_initialized()
    rank, world = dp_rank(), dp_world()
    device = resolve_device(args.device, "--device")
    if distributed and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())  # cuda:LOCAL_RANK
    local_batch = process_local_batch_size(args.batch_size)
    if distributed and args.wordy:
        print(f"Data-parallel training: rank {rank} of {world} on {device}, {local_batch} of "
              f"{args.batch_size} rows a step; backends: cuda {backend_for('cuda')}, "
              f"cpu {backend_for('cpu')}")
    if not args.use_fp16:
        # f32 compute means f32 arithmetic throughout: the hand-written
        # kernels' f32 paths use no TF32, so cuDNN's convolutions and
        # cuBLAS's products (TF32 by PyTorch's default) are held to the same
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    model_args = dict(MODEL_PRESETS["EMNIST"])
    diff_args = dict(DIFFUSION_PRESETS["EMNIST"])
    if args.prediction_type != "eps":
        diff_args["prediction_type"] = args.prediction_type
    # user-explicit model-group flags override the preset, so small custom
    # models can be trained through the same script. Flags whose parser
    # default is None are "explicit iff given"; the boolean store_true flags
    # keep the preset's values.
    for key in ("resolution", "model_channels", "num_res_blocks",
                "num_classes", "num_head_channels"):
        v = getattr(args, key)
        if v is not None:
            model_args[key] = v
    if args.channel_mult is not None:
        model_args["channel_mult"] = tuple(int(c) for c in args.channel_mult.split("/"))
    if args.attention_resolutions is not None:
        s = args.attention_resolutions
        model_args["attention_resolutions"] = (
            tuple(int(c) for c in s.split("/")) if s else ()
        )

    # null class for classifier-free guidance (reference train.py:39-40)
    if diff_args["guidance_method"] == "classifier_free":
        model_args["num_classes"] += 1

    model = DiffusionModel(
        **model_args,
        # reference train.py:42 trains with grad checkpointing
        use_remat=not args.no_grad_checkpoint,
        dtype=torch.bfloat16 if args.use_fp16 else None,
        device=device,
    )

    # each process loads its local share of the global batch, seeded by its rank
    def synthetic():
        return synthetic_batches(
            batch_size=local_batch,
            resolution=model_args["resolution"],
            channels=model_args["in_channels"],
            num_classes=model_args["num_classes"],
            seed=rank,
        )

    if args.synthetic:
        loader = synthetic()
    else:
        try:
            # prefer the native C++ prefetching loader, else numpy
            from ..training.native_loader import is_available, native_emnist_batches

            if is_available():
                loader = native_emnist_batches(local_batch, root=args.data_root, seed=rank)
            else:
                loader = emnist_batches(local_batch, root=args.data_root, seed=rank)
        except FileNotFoundError as e:
            print(f"{e}\nFalling back to --synthetic data.")
            loader = synthetic()

    os.makedirs(args.samples_dir, exist_ok=True)

    def save_samples(imgs, labels):
        for i in range(len(imgs)):
            label = int(labels[i]) if labels is not None else i
            save_image(imgs[i], os.path.join(args.samples_dir, f"train_sample_{label}_{i}.png"))

    trainer = Trainer(
        model=model,
        diffusion_args=diff_args,
        dataloader=loader,
        iterations=args.iterations,
        batch_size=args.batch_size,
        lr=args.lr,
        weight_decay=args.weight_decay,
        ema_rate=args.ema_rate,
        grad_accumulation=args.grad_accumulation,
        checkpoint_dir=args.checkpoint_dir,
        resume_step=args.resume_step,
        print_every=args.print_every if args.wordy else None,
        sample_every=args.sample_every,
        save_every=args.save_every,
        seed=args.seed if args.seed is not None else 0,
        metrics_path=args.metrics_path,
        sample_callback=save_samples,
        device=device,
        distributed=distributed,
    )
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
