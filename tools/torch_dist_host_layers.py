"""The host's own time in a rank's profiled step, by layer, from the
cProfile stats that ``chip_smoke.py --phases build,dist --dist-profile
DIR`` leaves in DIR (one ``<run>.prof`` for the one-rank run and for
each rank of each configuration); the layers are ``chip_smoke.py``'s
HOST_LAYERS.

    python3 tools/torch_dist_host_layers.py DIR
"""
import glob
import importlib.util
import os
import pstats
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for path in sorted(glob.glob(os.path.join(sys.argv[1], "*.prof"))):
        layers = smoke.host_layers(pstats.Stats(path))
        print(f"{os.path.basename(path)[:-5]}: {sum(layers.values()):.1f} "
              "ms own time; " + ", ".join(
                  f"{k} {v:.1f}" for k, v in
                  sorted(layers.items(), key=lambda kv: -kv[1])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
