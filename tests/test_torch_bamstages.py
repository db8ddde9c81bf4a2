"""markdup in the port against the reference on a bucket tree: the
in-memory columnar path and the streamed (spilling) path, flagging or
removing duplicates, give record-equal BAMs.  The slice test in
``test_torch_germline.py`` covers only the in-memory path on a single
BAM; the streamed path is what a whole-genome bucket tree takes."""
import sys
from pathlib import Path

import pytest
import torch

from falcon_genome_tpu.config import Config, Machine
from falcon_genome_tpu.io import native_ext
from falcon_genome_tpu.stages import bamstages as J
from falcon_genome_tpu.utils.compare import compare_bam
from falcon_genome_tpu_torch.stages import bamstages as T

sys.path.insert(0, str(Path(__file__).parent))
from test_markdup_stream import bucket_world  # noqa: E402,F401  (fixture)

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(
    not native_ext.available(), reason="native ext required for streaming")


@pytest.mark.parametrize("streamed", [True, False])
@pytest.mark.parametrize("remove", [False, True])
def test_markdup_bucket_tree_matches_reference(bucket_world, tmp_path,
                                               caplog, streamed, remove):
    folder = tmp_path / "buckets"
    folder.mkdir()
    for p in bucket_world["parts"]:
        (folder / Path(p).name).symlink_to(p)
    conf = Config(machine=Machine(8, 16), environ={}, load_files=False)
    conf.set("temp_dir", str(tmp_path))
    # 0 MiB streams every bucket tree; the world is far below 64 MiB
    conf.set("tpu.bam.stream_mb", 0 if streamed else 64)
    extra = ["-r"] if remove else None
    out = {}
    for name, run in (("ref", J.run_markdup), ("port", T.run_markdup)):
        out[name] = str(tmp_path / f"{name}.bam")
        caplog.clear()
        with caplog.at_level("INFO", logger="falcon_genome_tpu"):
            run(conf, str(folder), out[name], force=True, extra_opts=extra)
        assert ("markdup (streamed" in caplog.text) == streamed
    d = compare_bam(out["ref"], out["port"], compare_tags=True)
    assert d.equivalent and d.matching > 1000, d
