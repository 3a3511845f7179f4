"""Run the reference's jaxpr rules J001–J005 live and print, as one JSON
object, which of its targets each of J001–J004 flags and which stand-in
sweeps J005 flags.

The reference's own runner imports ``jax.experimental.enable_x64``, which
jax 0.9.0 removed, so this traces its targets itself (``jax.make_jaxpr``
under x32 and under ``jax.enable_x64(True)``), wraps the traces in its
``TracedTarget`` and calls its rule functions one target at a time.
``tests/test_torch_analysis_ops.py`` runs it in a subprocess beside the
port's recordings and holds the port's target sets to these.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_lint/reference_jrules.py ROOT
"""
import json
import sys
import warnings


def main(root: str) -> dict:
    import jax

    from repro.analysis.jaxpr import fingerprint, rules, targets
    traced = {}
    for t in targets.all_targets():
        fn, args = t.build()
        j32 = jax.make_jaxpr(fn)(*args)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                with jax.enable_x64(True):
                    j64, err = jax.make_jaxpr(fn)(*args), None
        except Exception as e:           # a J002 signal, as the reference's
            j64, err = None, e
        traced[t.name] = targets.TracedTarget(t, j32, j64, err)
    out = {rid: sorted(name for name, tt in traced.items()
                       if list(check({name: tt}, root)))
           for rid, check in (("J001", rules.check_j001),
                              ("J002", rules.check_j002),
                              ("J003", rules.check_j003),
                              ("J004", rules.check_j004))}
    out["J005"] = sorted(f.symbol for f in fingerprint.check_j005({}, root))
    out["targets"] = sorted(traced)
    return out


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1])))
