import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card (a hand-written kernel of repro_torch has "
        "no CPU mode); skips where torch.cuda.is_available() is False",
    )


def make_tiny_root(dst, n_lists=8, min_len=300, max_len=20_000):
    """A checkout of the benchmark at a size the CPU runs in a second:
    ``BENCHMARK.json`` and ``bench/`` copied under ``dst``, every
    configuration cut to ``n_lists`` short lists, every mix to pools of 64
    queries, batches and waves of 8 and one warm-up call."""
    import json
    import shutil

    shutil.copytree(HERE, os.path.join(dst, "bench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    cdir = os.path.join(dst, "bench", "configs")
    for f in os.listdir(cdir):
        p = os.path.join(cdir, f)
        with open(p) as fh:
            c = json.load(fh)
        c.update(n_lists=n_lists, min_len=min_len, max_len=max_len)
        with open(p, "w") as fh:
            json.dump(c, fh)
    tdir = os.path.join(dst, "bench", "traffic")
    for f in os.listdir(tdir):
        p = os.path.join(tdir, f)
        with open(p) as fh:
            c = json.load(fh)
        c.update(pool=64, warmup=1)
        for key in ("batch", "clients", "max_batch"):
            if key in c:
                c[key] = 8
        with open(p, "w") as fh:
            json.dump(c, fh)
    return str(dst)
