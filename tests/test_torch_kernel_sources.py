"""The port's CUDA sources against the wrappers that build and launch them,
on the CPU: every ``csrc/*.cu`` has exactly one loader in ``ops/``, the
launch counters name exactly the builds the wrappers launch, and the
merge-tree fold's build numbers are the ones its source compiles."""

import glob
import os
import re

import pytest

from fluidframework_tpu_torch.ops import fold_cuda
from fluidframework_tpu_torch.ops.launches import (launch_counts,
                                                   reset_launches)

PACKAGE = os.path.dirname(os.path.dirname(fold_cuda.__file__))
CSRC = os.path.join(PACKAGE, "csrc")
OPS = os.path.join(PACKAGE, "ops")
KERNEL_SOURCES = sorted(os.path.basename(p)[:-len(".cu")]
                        for p in glob.glob(os.path.join(CSRC, "*.cu")))

#: every build an entry point launches, by placement where it has two
LIVE_COUNTS = {
    "fold_smem", "fold_gmem", "fold_export_smem", "fold_export_gmem",
    "matrix_fold_smem", "matrix_fold_gmem", "map_lww", "splice_rows",
    "widen_resident", "tree_fold_smem", "tree_fold_gmem",
    "tree_fold_digest_smem", "tree_fold_digest_gmem"}


def _read(path):
    with open(path) as f:
        return f.read()


def test_the_kernel_sources_are_the_five_launched():
    assert KERNEL_SOURCES == ["map_lww", "matrix_fold", "mergetree_fold",
                              "resident", "tree_fold"]


@pytest.mark.parametrize("name", KERNEL_SOURCES)
def test_every_kernel_source_has_one_loader(name):
    """A source no wrapper loads is a kernel no entry point can launch."""
    loaders = [(os.path.basename(p), n) for p in
               sorted(glob.glob(os.path.join(OPS, "*.py")))
               for n in [_read(p).count(f'load("{name}")')] if n]
    assert [n for _f, n in loaders] == [1], loaders


def test_launch_counts_name_every_live_build():
    reset_launches()
    assert launch_counts() == dict.fromkeys(LIVE_COUNTS, 0)


def test_fold_builds_match_the_source():
    """``fold_cuda._VARIANTS`` numbers the four builds as the source's
    ``kernel_of`` does (variant = kGmem | kExport << 1), and the occupancy
    entry takes those four and no other."""
    assert sorted(fold_cuda._VARIANTS.values()) == [0, 1, 2, 3]
    src = _read(os.path.join(CSRC, "mergetree_fold.cu"))
    body = re.search(r"const void\* kernel_of\(int variant\) \{(.*?)\n\}",
                     src, re.S).group(1)
    cases = re.findall(r"(case (\d)|default): return reinterpret_cast"
                       r"<const void\*>\(\s*&mergetree_fold_kernel<(\w+), "
                       r"(\w+)>\);", body)
    # the default case is the last build: the occupancy entry below
    # refuses every variant past it
    built = {int(n) if n else len(cases) - 1: (g == "true", e == "true")
             for _c, n, g, e in cases}
    assert sorted(built) == [0, 1, 2, 3]
    for (kernel, where), variant in fold_cuda._VARIANTS.items():
        assert built[variant] == (where == "gmem", kernel == "fold_export")
        assert variant == int(where == "gmem") | int(
            kernel == "fold_export") << 1
    assert "if (variant < 0 || variant > 3) return" in src
