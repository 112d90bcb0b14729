"""chip_smoke.py on the CPU: its host count oracle agrees with the count
pipeline, and the script refuses to run without a GPU."""

import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

from strainscan_tpu.index.hashtable import KmerTable  # noqa: E402
from strainscan_tpu.io import fastx  # noqa: E402
from strainscan_tpu.ops.count import CountPipeline  # noqa: E402


@pytest.fixture(scope="module")
def small_sample(tmp_path_factory):
    rng = np.random.default_rng(3)
    genome = rng.integers(0, 4, size=30_000).astype(np.uint8)
    keys = chip_smoke.table_keys(genome)
    codes, lens = chip_smoke.synth_reads(rng, genome, 900, n_frac=0.1,
                                         short_frac=0.05)
    path = str(tmp_path_factory.mktemp("smoke") / "s.fq")
    chip_smoke.write_fastq(path, codes, lens)
    return keys, codes, path


@pytest.mark.parametrize("probe_mode", ["fp", "exact"])
def test_host_oracle_equals_count_pipeline(small_sample, probe_mode):
    keys, codes, path = small_sample
    want = chip_smoke.host_counts(keys, codes, chunk=256)
    assert want.sum() > 0
    pipe = CountPipeline(KmerTable.build(keys, k=chip_smoke.K),
                         probe_mode=probe_mode)
    for b in fastx.read_batches(path, batch=512, maxlen=160,
                                k=chip_smoke.K):
        pipe.add_batch(b)
    np.testing.assert_array_equal(pipe.finish(), want)


@pytest.mark.parametrize("argv", [[], ["--cards", "4"]],
                         ids=["one_card", "four_cards"])
def test_main_fails_without_gpu(monkeypatch, capsys, argv):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert chip_smoke.main(argv) != 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    with pytest.raises(json.JSONDecodeError):
        json.loads(last)
