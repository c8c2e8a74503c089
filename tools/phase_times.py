"""Each phase's seconds in one run of a ``chip_smoke.py``: the script of
this checkout, or of the checkout whose ``chip_smoke.py`` is given (an
older commit unpacked beside this one, to compare the two in one call on
one card).  It imports that script, wraps each of its top-level functions
named ``*_phase``, ``*_phases``, ``*_check`` or ``*_rounds`` with a wall
clock (a phase that another calls counts in its caller's time), runs its
``main`` and then prints one JSON line: the seconds a phase, summed over
its calls, ``main``'s seconds and the rest of them.

    python3 tools/phase_times.py [PATH/chip_smoke.py]
"""
import functools
import inspect
import json
import pathlib
import sys
import time

SUFFIXES = ("_phase", "_phases", "_check", "_rounds")


def main(argv) -> int:
    script = pathlib.Path(argv[0] if argv else pathlib.Path(__file__)
                          .resolve().parents[1] / "chip_smoke.py").resolve()
    # the spawned workers import the same script by this path
    sys.path.insert(0, str(script.parent))
    import chip_smoke

    if pathlib.Path(chip_smoke.__file__).resolve() != script:
        raise SystemExit(f"phase_times: imported {chip_smoke.__file__}, "
                         f"not {script}")
    seconds, depth = {}, [0]

    def timed(name, fn):
        @functools.wraps(fn)
        def run(*args, **kw):
            if depth[0]:
                return fn(*args, **kw)
            depth[0] += 1
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                depth[0] -= 1
                seconds[name] = seconds.get(name, 0.0) + \
                    time.perf_counter() - t0
        return run

    for name, fn in list(vars(chip_smoke).items()):
        if (inspect.isfunction(fn) and fn.__module__ == "chip_smoke"
                and name.endswith(SUFFIXES)):
            setattr(chip_smoke, name, timed(name, fn))
    t0 = time.perf_counter()
    rc = chip_smoke.main()
    total = time.perf_counter() - t0
    print(json.dumps({"script": str(script), "phase_seconds": seconds,
                      "main_s": total,
                      "rest_s": total - sum(seconds.values())}))
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
