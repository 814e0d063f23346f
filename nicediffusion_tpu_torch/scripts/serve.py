"""Serving daemon: long-lived batched sampling over HTTP (torch; one device,
or one process per GPU).

Counterpart of scripts/serve.py of the JAX package. It builds the model and
diffusion as the sampling entry point does (scripts/sample.py: the same
flags, preset dispatch by model-path substring, ``--custom``, strict loading
of a ``.pt`` or ``.npz``, ``--dtype`` with static int8 calibrated or loaded
through ``--int8_calibration``), runs the chain once at the fixed serving
batch to build the kernels (``--no_warmup`` skips that), then micro-batches
concurrent HTTP requests into it (nicediffusion_tpu_torch/serving/). It
serves on the CUDA card unless ``--cpu`` is given, and raises where there is
no card. No classifier is built, as in the JAX script.

``--serve_data_parallel`` serves each batch sharded over the GPUs, one
process per GPU launched by torchrun (parallel/multihost.py: gloo carries
the batch's x_T, labels and images between the processes as CPU tensors):
rank 0 runs the HTTP front end and the batcher, every rank denoises its rows
of each batch, the other ranks follow rank 0 until it stops
(serving/service.py). ``--batch_size`` must be a multiple of the process
count. Without torchrun's environment the flag changes nothing; launched by
torchrun without it, the daemon refuses to start.

Usage:
  python -m nicediffusion_tpu_torch.scripts.serve --model_path 64x64_diffusion.pt \\
      --batch_size 32 [--dtype int8 --int8_calibration calib.npz] \\
      [--encoder_cache 2] [--guidance_interval 0.1 0.7] \\
      [--port 8000] [--linger_ms 5] [-w]
  python -m torch.distributed.run --nproc_per_node N \\
      -m nicediffusion_tpu_torch.scripts.serve --serve_data_parallel [same flags]

Then:
  curl -s localhost:8000/healthz
  curl -s -X POST localhost:8000/sample \\
      -d '{"labels": [3], "seed": 0, "encoding": "list"}'
  curl -s localhost:8000/stats

--batch_size is the serving batch (requests are packed into it);
--num_samples is not used by the daemon (any value is accepted and ignored).
"""

from __future__ import annotations

import sys


def _parser():
    from ..utils.cli import make_argparser

    parser = make_argparser("diff_sample")
    parser.add_argument("--port", type=int, default=8000, help="HTTP port (0 = ephemeral)")
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--linger_ms", type=float, default=5.0,
                        help="micro-batching window: max ms a request waits "
                             "for co-batched requests before a partial "
                             "batch is flushed")
    parser.add_argument("--no_warmup", action="store_true", default=False,
                        help="skip the startup chain (the first request pays "
                             "for the kernel build)")
    parser.add_argument("--request_timeout", type=float, default=600.0,
                        help="seconds an HTTP handler waits on its batch "
                             "before failing the request with a 500 (bounds "
                             "handler-thread pileup if the worker dies)")
    parser.add_argument("--serve_data_parallel", action="store_true", default=False,
                        help="serve each batch sharded over the processes of a "
                             "torchrun launch, one per GPU")
    return parser


def build_service(argv: list[str] | None = None):
    """Parse ``argv`` (default: the command line; the sampling flags plus
    the serving flags) and return (a `SamplerService`, warm unless
    ``--no_warmup``, the parsed arguments). Under torchrun with
    ``--serve_data_parallel`` it joins the process group first; on a rank
    > 0 the service is to be driven by its ``follow()``."""
    args_in = list(sys.argv[1:] if argv is None else argv)
    # the daemon serves until stopped; the shared parser requires
    # --num_samples, so it is defaulted here
    if "--num_samples" not in args_in:
        args_in += ["--num_samples", "0"]
    args = _parser().parse_args(args_in)

    from ..parallel import maybe_initialize_distributed
    from ..parallel import world as dp_world
    from ..serving import SamplerService, ServingConfig
    from ..utils.cli import build_diffusion, get_dicts_from_args

    other_args, model_args, diff_args = get_dicts_from_args(args)
    wordy = other_args["wordy"]
    seed = other_args["seed"] if other_args["seed"] is not None else 0

    # under torchrun: join the group before the first device use, and check
    # the serve batch against it before any model is built
    maybe_initialize_distributed()
    world = dp_world()
    if world > 1 and not args.serve_data_parallel:
        raise ValueError(f"launched as {world} processes: pass --serve_data_parallel")
    if args.batch_size % world:
        raise ValueError(f"serve_batch={args.batch_size} must be a multiple of the 'data' "
                         f"axis size {world} (the process count)")
    diffusion = build_diffusion(other_args, model_args, diff_args, args.batch_size,
                                classifier=False)

    gi = other_args["guidance_interval"]
    service = SamplerService(
        diffusion,
        ServingConfig(
            serve_batch=args.batch_size,
            linger_ms=args.linger_ms,
            encoder_cache=other_args["encoder_cache"],
            guidance_interval=tuple(gi) if gi else None,
            rng_seed=seed,
        ),
        device=diffusion.device,
        distributed=world > 1,
    )
    if not args.no_warmup:
        if wordy:
            print(f"Running the chain once at batch {args.batch_size} (kernel build)...")
        try:
            service.warmup()
        except BaseException:
            service.close()
            raise
    return service, args


def main(argv: list[str] | None = None):
    from ..parallel import rank as dp_rank
    from ..serving import make_server

    service, args = build_service(argv)
    if dp_rank():  # data-parallel: rank 0 takes the requests
        service.follow()
        return
    server = make_server(service, host=args.host, port=args.port,
                         request_timeout=args.request_timeout)
    host, port = server.server_address
    print(f"serving on http://{host}:{port} "
          f"(batch {args.batch_size}, linger {args.linger_ms} ms)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.close()


if __name__ == "__main__":
    main()
