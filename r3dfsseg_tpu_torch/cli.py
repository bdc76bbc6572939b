"""The port's CLI plumbing (counterpart of `r3dfsseg_tpu/cli.py`): the
JAX package's flag surface -> R3DConfig.

Flag names, defaults and choices are the JAX CLI's (pinned by
tests/test_torch_cli.py), which are the original code's; list-valued flags
are parsed with ast.literal_eval as there.  The port adds ``--device``
(default "cuda"; the tests pass "cpu").  A flag value the port does not run
raises NotImplementedError naming its ROADMAP.md item (`check_supported`);
``--transfer_batch`` and ``--wire_format`` int8/none, which shape the TPU
build's host-to-device transfers, are accepted and change no number.
``--mesh N`` (N > 1) runs the entry point on N data-parallel ranks
(`parallel/launch.py`: spawned here, or the ranks of `torchrun`); with
``--device cpu`` they are gloo ranks on the CPU.
"""
from __future__ import annotations

import argparse
import ast
import os

from r3dfsseg_tpu_torch.config import R3DConfig
from r3dfsseg_tpu_torch.parallel.mesh import resolve_episode_batch  # noqa: F401


def build_parser(eval_mode: bool = False) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    # data
    choices = ["pretrain", "finetune", "prototrain", "protoeval",
               "mptitrain", "mptieval", "mptinoise_eval",
               "transformertrain", "transformereval"]
    p.add_argument("--phase", type=str,
                   default="mptinoise_eval" if eval_mode else "mptitrain",
                   choices=choices)
    p.add_argument("--dataset", type=str, default="s3dis")
    p.add_argument("--cvfold", type=int, default=0)
    p.add_argument("--data_path", type=str, default="")
    p.add_argument("--pretrain_checkpoint_path", type=str, default=None)
    p.add_argument("--model_checkpoint_path", type=str, default=None)
    p.add_argument("--save_path", type=str, default="./log_s3dis/")
    p.add_argument("--eval_interval", type=int, default=2000)
    # optimization
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--n_workers", type=int, default=16)
    p.add_argument("--n_iters", type=int, default=40000)
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--step_size", type=int, default=5000)
    p.add_argument("--gamma", type=float, default=0.5)
    # episodes
    p.add_argument("--n_way", type=int, default=2)
    p.add_argument("--k_shot", type=int, default=5)
    p.add_argument("--n_queries", type=int, default=1)
    p.add_argument("--n_episode_test", type=int, default=100)
    # point clouds
    p.add_argument("--pc_npts", type=int, default=2048)
    p.add_argument("--pc_attribs", default="xyzrgbXYZ")
    p.add_argument("--pc_augm", action="store_true")
    p.add_argument("--pc_augm_scale", type=float, default=0)
    p.add_argument("--pc_augm_rot", type=int, default=1)
    p.add_argument("--pc_augm_mirror_prob", type=float, default=0)
    p.add_argument("--pc_augm_jitter", type=int, default=1)
    # backbone
    p.add_argument("--dgcnn_k", type=int, default=20)
    p.add_argument("--edgeconv_widths", default="[[64,64], [64, 64], [64, 64]]")
    p.add_argument("--dgcnn_mlp_widths", default="[512, 256]")
    p.add_argument("--base_widths", default="[128, 64]")
    p.add_argument("--output_dim", type=int, default=64)
    p.add_argument("--use_attention", action="store_true")
    p.add_argument("--dg_atten_dim", type=int, default=128)
    # protonet
    p.add_argument("--dist_method", default="cosine")
    # mpti
    p.add_argument("--n_subprototypes", type=int, default=100)
    p.add_argument("--k_connect", type=int, default=200)
    p.add_argument("--sigma", type=float, default=1.0,
                   help="gaussian affinity bandwidth; <= 0 = per-episode "
                        "auto bandwidth (scale-invariant graph)")
    # noise
    p.add_argument("--clean_data_path", type=str, default="")
    p.add_argument("--log_dir", type=str, default="debug")
    p.add_argument("--ReturnCluster", default=False)
    p.add_argument("--seed", default=123, type=int)
    p.add_argument("--train_noise_ratio", default="[0.2]")
    p.add_argument("--shot_seed", type=int, default=1)
    if eval_mode:
        p.add_argument("--noise_ratio", type=float, default=0.4)
        p.add_argument("--noise_type", default="sym", type=str)
        # class -> confusion partner for --noise_type pair, e.g.
        # "{0: 3, 3: 0}".  The reference's pair branch crashes (its dict is
        # commented out, loader.py:592-593); here it is explicit input.
        p.add_argument("--noise_pair_dict", type=str, default="")
        p.add_argument("--save_test_record", dest="save_test_record",
                       action="store_true")
    # transformer baseline config.  Defaults are the reference's *effective*
    # architecture: its CLI parses 192/4/1/128 (eval_noise.py:229-233) but
    # the model hard-codes 128/8/3/128 (models/protonet.py:1141-1147).
    p.add_argument("--d_model", type=int, default=128)
    p.add_argument("--n_head", type=int, default=8)
    p.add_argument("--d_feed", type=int, default=128)
    p.add_argument("--n_layers", type=int, default=3)
    # Dead in the reference too: parsed at mpti_train_noise.py:241-242 and
    # never read anywhere.  Kept so scripts written against the reference
    # flag surface don't crash.
    p.add_argument("--proto_path", type=str, default="")
    p.add_argument("--num_spectra_group", type=int, default=4)
    # ---- implementation knobs ----
    p.add_argument("--episode_batch", type=int, default=0,
                   help="episodes per optimizer step (0 = auto: one per "
                        "device)")
    p.add_argument("--mesh", type=int, default=0,
                   help="data parallelism over N ranks, one device each "
                        "(0 = auto: every visible GPU); more GPUs than the "
                        "host has raises")
    p.add_argument("--lp_solver", default="cheby",
                   choices=["cg", "cheby", "solve"])
    p.add_argument("--lp_cg_iters", type=int, default=50)
    p.add_argument("--lp_adjoint_iters", type=int, default=0,
                   help="iterations for the backward (adjoint) LP solve; "
                        "0 = same as --lp_cg_iters")
    p.add_argument("--knn_impl", default="auto",
                   choices=["auto", "pallas", "pallas_exact", "xla",
                            "approx"])
    p.add_argument("--attn_impl", default="auto",
                   choices=["auto", "pallas", "xla"])
    p.add_argument("--affinity_impl", default="threshold",
                   choices=["threshold", "topk"])
    p.add_argument("--wire_format", default="int8",
                   choices=["none", "int8", "f16"],
                   help="the TPU build's host-to-device format; int8 and "
                        "none change no number here, f16 raises")
    p.add_argument("--transfer_batch", type=int, default=8,
                   help="the TPU build's transfer grouping; accepted, "
                        "changes nothing here")
    p.add_argument("--compute_dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--graph_dtype", default="auto",
                   choices=["auto", "float32", "bfloat16"],
                   help="affinity/LP graph precision; auto follows "
                        "--compute_dtype")
    p.add_argument("--attn_f32", action="store_true",
                   help="keep attention matmuls f32 even in bf16 mode")
    p.add_argument("--bn_mode", default="fastvar",
                   choices=["exact", "fastvar", "hybrid", "stats", "relaxed"],
                   help="BatchNorm precision in bf16 mode: fastvar = f32 "
                        "single-pass stats + f32 outputs (default — "
                        "convergence A/B in-band, and identical to exact "
                        "without a bf16 compute dtype); exact = f32 "
                        "two-pass stats + f32 outputs (bf16 fast-var BN "
                        "loses ~0.1 mean-IoU in meta-training A/Bs); "
                        "hybrid = f32 outputs only for the BNs "
                        "that feed the 192-d embedding directly, relaxed "
                        "elsewhere; stats = f32 stats, bf16 outputs; "
                        "relaxed = bf16 fast-var (bandwidth benchmarks "
                        "only)")
    p.add_argument("--profile_dir", type=str, default=None)
    # ---- the port's own ----
    p.add_argument("--device", type=str, default="cuda",
                   help="the torch device to run on; without a GPU the default "
                        "raises (pass cpu to run on the CPU)")
    return p


def args_to_config(args: argparse.Namespace, eval_mode: bool = False) -> R3DConfig:
    cfg = R3DConfig(
        phase=args.phase, dataset=args.dataset, cvfold=args.cvfold,
        pretrain_checkpoint_path=args.pretrain_checkpoint_path,
        model_checkpoint_path=args.model_checkpoint_path,
        save_path=args.save_path, eval_interval=args.eval_interval,
        data_path=getattr(args, "data_path", ""),
        clean_data_path=args.clean_data_path,
        batch_size=getattr(args, "batch_size", 1),
        n_workers=getattr(args, "n_workers", 8),
        n_iters=getattr(args, "n_iters", 40000),
        lr=args.lr if hasattr(args, "lr") else 0.001,
        step_size=getattr(args, "step_size", 5000),
        gamma=getattr(args, "gamma", 0.5),
        n_way=args.n_way, k_shot=args.k_shot, n_queries=args.n_queries,
        n_episode_test=args.n_episode_test,
        pc_npts=args.pc_npts, pc_attribs=args.pc_attribs,
        pc_augm=args.pc_augm, pc_augm_scale=args.pc_augm_scale,
        pc_augm_rot=args.pc_augm_rot,
        pc_augm_mirror_prob=args.pc_augm_mirror_prob,
        pc_augm_jitter=args.pc_augm_jitter,
        dgcnn_k=args.dgcnn_k,
        edgeconv_widths=tuple(map(tuple, ast.literal_eval(args.edgeconv_widths))),
        dgcnn_mlp_widths=tuple(ast.literal_eval(args.dgcnn_mlp_widths)),
        base_widths=tuple(ast.literal_eval(args.base_widths)),
        output_dim=args.output_dim, use_attention=args.use_attention,
        dg_atten_dim=args.dg_atten_dim, dist_method=args.dist_method,
        n_subprototypes=args.n_subprototypes, k_connect=args.k_connect,
        sigma=args.sigma,
        train_noise_ratio=tuple(ast.literal_eval(args.train_noise_ratio)),
        noise_ratio=getattr(args, "noise_ratio", 0.0),
        noise_type=getattr(args, "noise_type", "sym"),
        noise_pair_dict=(ast.literal_eval(args.noise_pair_dict)
                         if getattr(args, "noise_pair_dict", "") else None),
        save_test_record=getattr(args, "save_test_record", False),
        d_model=args.d_model, n_head=args.n_head,
        n_layers=args.n_layers, d_feed=args.d_feed,
        shot_seed=args.shot_seed, seed=args.seed,
        mesh_shape=(args.mesh,) if getattr(args, "mesh", 0) > 0 else None,
        episode_batch=args.episode_batch, lp_solver=args.lp_solver,
        lp_cg_iters=args.lp_cg_iters,
        lp_adjoint_iters=args.lp_adjoint_iters, knn_impl=args.knn_impl,
        attn_impl=args.attn_impl, affinity_impl=args.affinity_impl,
        wire_format=getattr(args, "wire_format", "int8"),
        transfer_batch=getattr(args, "transfer_batch", 8),
        compute_dtype=args.compute_dtype,
        graph_dtype=getattr(args, "graph_dtype", "auto"),
        attn_f32=getattr(args, "attn_f32", False),
        bn_mode=getattr(args, "bn_mode", "fastvar"),
        profile_dir=args.profile_dir,
        log_dir=args.log_dir if hasattr(args, "log_dir") else "debug",
    )
    if not eval_mode:
        # log dir layout (mpti_train_noise.py:255-257)
        cfg = cfg.replace(log_dir=os.path.join(
            args.save_path, "Cleantrain",
            "S%d_N%d_K%d_Att%d" % (args.cvfold, args.n_way, args.k_shot,
                                   int(args.use_attention)),
            args.log_dir))
    else:
        cfg = cfg.replace(log_dir=args.model_checkpoint_path or args.log_dir)
    check_supported(cfg)
    return cfg


def check_supported(cfg: R3DConfig) -> None:
    """Raise NotImplementedError on a setting the JAX CLI runs and the port
    does not yet, naming its ROADMAP.md item."""
    if cfg.knn_impl == "approx":
        raise NotImplementedError("--knn_impl approx: the TPU's approximate top-k has no port "
                                  "(ROADMAP.md, 'Not queued')")
    if cfg.wire_format == "f16":
        raise NotImplementedError("--wire_format f16 sends f16 point attributes, which changes "
                                  "the numbers; the port sends f32 (ROADMAP.md, 'Not queued')")

