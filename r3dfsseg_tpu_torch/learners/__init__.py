"""The learners: the MPTI model's and the baselines'."""
from r3dfsseg_tpu_torch.learners.mpti_learner import MPTILearner  # noqa: F401
from r3dfsseg_tpu_torch.learners.proto_learner import ProtoLearner  # noqa: F401
from r3dfsseg_tpu_torch.learners.transformer_learner import TransformerLearner  # noqa: F401


def make_learner(cfg, device=None):
    """The learner of ``cfg.phase`` on ``device`` ("cuda" when None), as
    the JAX package picks it (`serve.py:_make_learner`, `eval_noise.py:
    make_learner`): the MPTI phases an `MPTILearner`, the ProtoNet phases a
    `ProtoLearner` with the contrast variant, the transformer phases a
    `TransformerLearner`; any other phase raises."""
    if cfg.phase in ("mptinoise_eval", "mptieval", "mptitrain"):
        return MPTILearner(cfg, device)
    if cfg.phase in ("protoeval", "prototrain"):
        return ProtoLearner(cfg, device, with_contrast=True)
    if cfg.phase in ("transformereval", "transformertrain"):
        return TransformerLearner(cfg, device)
    raise NotImplementedError(f"phase {cfg.phase!r} has no learner")
