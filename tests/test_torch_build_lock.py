"""The lazy builds under threads: two jobs of the threaded service can
reach a library's first use at once. The first build is serialized by a
lock, so two concurrent first calls build once and both load it."""
import subprocess
import threading
import time

import numpy as np
import torch

from bayesian_optimization_tpu_torch import native

torch.set_num_threads(1)  # one thread per pytest worker: more oversubscribe the cores


def test_two_threads_build_the_wfg_library_once(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path)
    real_run, builds = subprocess.run, []

    def counting_run(cmd, *args, **kwargs):
        if cmd and cmd[0] == "g++":
            builds.append(cmd)
            time.sleep(0.5)  # hold the build open: the other thread arrives meanwhile
        return real_run(cmd, *args, **kwargs)

    monkeypatch.setattr(native.subprocess, "run", counting_run)
    native.load_library.cache_clear()
    start, libs, errors = threading.Barrier(2), [None, None], []

    def first_call(i):
        try:
            start.wait()
            libs[i] = native.load_library()
        except Exception as e:  # reported below, not swallowed
            errors.append(e)

    try:
        threads = [threading.Thread(target=first_call, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not errors, errors
        assert len(builds) == 1, builds
        assert all(lib is not None for lib in libs)
        assert sorted(p.name for p in tmp_path.iterdir()) == [native.library_path().name]
        # both threads hold a loadable library: the unit square's hypervolume
        assert native.wfg_hypervolume(np.array([[1.0, 1.0]]), np.zeros(2)) == 1.0
    finally:
        native.load_library.cache_clear()
