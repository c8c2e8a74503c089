"""ROADMAP C10's two outputs: on ``test_torch_tp_rwkv.py``'s meshes and
input, each leaf's gathered tensor-parallel gradient, the port's
one-process gradient and the reference's one-ulp spread
(``torch_tp_family.reference(..., ulp_draws)``), each as a share of the
leaf's largest ``jax.grad`` entry, and the ratio the test's bound reads:
(share(tp, jax) - 1e-4) / spread, which it holds to 2.

Run: ``PYTHONPATH=src:tests python tests/rwkv_tp_gradients.py [DRAWS]``
(8 draws by default, as the test); about a minute on the CPU.
"""
import pathlib
import sys
import tempfile

import torch_tp_family as fam
import test_torch_tp_rwkv as T


class _Dirs:
    """``run_meshes``'s ``tmp_path_factory``: folders under ``root``."""

    def __init__(self, root):
        self.root = root

    def mktemp(self, name):
        return pathlib.Path(tempfile.mkdtemp(prefix=name, dir=self.root))


def main(argv) -> int:
    draws = int(argv[0]) if argv else T.ULP_DRAWS
    refs = {e: fam.reference(T.ARCH, e, ulp_draws=draws)
            for e in {e for _, e in T.MESHES.values()}}
    with tempfile.TemporaryDirectory() as root:
        ranks = fam.run_meshes(_Dirs(root), T.ARCH, T.MESHES, refs)
    for mesh, (shape, extra) in T.MESHES.items():
        ref = refs[extra]
        _, model, specs = fam.specs_of(T.ARCH, extra, shape)
        grads = fam.full_leaves([o["grads"] for o in ranks[mesh]],
                                model.param_shapes, specs)
        whole = fam.whole_gradients(T.ARCH, extra, ref)
        print(f"{mesh}: leaf, share(tp, jax), share(whole, jax), "
              f"share(tp, whole), spread, ratio")
        worst = float("-inf")
        for k in sorted(grads):
            tj = fam._share(grads[k].numpy(), ref["grads"][k])
            sp = ref["ulp_spread"][k]
            ratio = (tj - 1e-4) / sp
            worst = max(worst, ratio)
            wj = fam._share(whole[k], ref["grads"][k])
            tw = fam._share(grads[k].numpy(), whole[k])
            print(f"  {k:24s} {tj:.3g} {wj:.3g} {tw:.3g} {sp:.3g} "
                  f"{ratio:.3g}")
        print(f"  largest ratio {worst:.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
