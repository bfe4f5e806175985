"""Sharding over ``torch.distributed`` (port of
``openmeasure_tpu/parallel``): the sharded pipelines of
:mod:`.sharded`, the collective helpers of :mod:`._comm` and the
spawned-world harness of :mod:`.harness`.

The names below load on first use, so that the solver modules can import
:mod:`._comm` without importing the pipelines built on them."""

_SHARDED = (
    "make_mesh", "shard_snapshots", "sharded_spr_step",
    "sharded_spr_cols_step", "sharded_gem_select", "sharded_dg_select",
    "sharded_vdg_select", "sharded_update_basis", "sharded_gpr_train",
    "sharded_gp_train_step", "init_mode_stacked_params",
    "sharded_mfk_end_to_end", "sharded_mode_lstsq", "gather_rows",
)
__all__ = list(_SHARDED)


def __getattr__(name):
    if name in _SHARDED:
        from . import sharded
        return getattr(sharded, name)
    raise AttributeError(
        f"module 'openmeasure_torch.parallel' has no attribute {name!r}")
