"""The port's counterpart of tests/test_doctests.py: the examples of the
twelve modules that counterpart the reference's doctest modules, a
docstring on every ``__all__`` name of every public module of the port,
and a runnable example on each of the seven flagship entry points.  Every
example runs on ``device="cpu"``; ``morton_partition``'s starts and ends a
one-rank gloo world of its own."""

import doctest
import importlib
import inspect
import pkgutil
import typing

import pytest

import pasture_tpu_torch

# importlib avoids package attributes that shadow submodules (the
# registration package's `icp` is the function)
MODULES = [importlib.import_module(n) for n in [
    "pasture_tpu_torch.layout.schema",
    "pasture_tpu_torch.layout.conversion",
    "pasture_tpu_torch.math.aabb",
    "pasture_tpu_torch.math.morton",
    "pasture_tpu_torch.io.base",
    "pasture_tpu_torch.io.streaming",
    "pasture_tpu_torch.ops.voxel",
    "pasture_tpu_torch.ops.voxel_merge",
    "pasture_tpu_torch.algorithms.normals",
    "pasture_tpu_torch.registration.icp",
    "pasture_tpu_torch.pipeline",
    "pasture_tpu_torch.parallel.partition",
]]


@pytest.mark.parametrize("module", MODULES, ids=lambda m: m.__name__)
def test_doctests(module):
    failures, _ = doctest.testmod(module, verbose=False)
    assert failures == 0


def _public_modules():
    """Every module of the port that declares ``__all__`` (but the native
    build helpers, which may run a compiler on import)."""
    out = []
    for info in pkgutil.walk_packages(pasture_tpu_torch.__path__,
                                      prefix="pasture_tpu_torch."):
        if ".native" in info.name:
            continue
        mod = importlib.import_module(info.name)
        if getattr(mod, "__all__", None):
            out.append(mod)
    return out


def test_every_public_name_is_documented():
    """Every ``__all__`` name of every public module carries a docstring
    (constants and typing aliases are documented by their module)."""
    missing = []
    for mod in _public_modules():
        for name in mod.__all__:
            obj = getattr(mod, name, None)
            if obj is None:
                missing.append(f"{mod.__name__}.{name} (unresolvable)")
                continue
            if isinstance(obj, (int, float, str, dict, tuple, frozenset)):
                continue
            if typing.get_origin(obj) is not None:
                continue
            doc = inspect.getdoc(obj)
            if not doc or not doc.strip():
                missing.append(f"{mod.__name__}.{name}")
    assert not missing, f"undocumented public names: {missing}"


def test_entry_points_have_runnable_examples():
    """The seven entry points of the reference's sweep carry an example."""
    by_name = {m.__name__: m for m in MODULES}
    p = "pasture_tpu_torch."
    targets = [
        by_name[p + "io.base"].read_all,
        by_name[p + "ops.voxel"].voxel_downsample,
        by_name[p + "ops.voxel_merge"].merge_voxel_batches,
        by_name[p + "algorithms.normals"].compute_normals,
        by_name[p + "registration.icp"].icp,
        by_name[p + "pipeline"].RegistrationPipeline,
        by_name[p + "parallel.partition"].morton_partition,
    ]
    for obj in targets:
        examples = doctest.DocTestFinder().find(obj)
        assert any(t.examples for t in examples), obj
