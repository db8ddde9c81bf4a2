"""``benchmarks/vcf_diff.py``: two VCFs compared in every field."""
import gzip
import json

from falcon_genome_tpu_torch.benchmarks import vcf_diff

HEADER = ("##fileformat=VCFv4.2\n"
          "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\ts1\n")
ROWS = [
    "chr1\t100\t.\tA\tG\t50.1\t.\tAC=1;DP=10\tGT:AD:GQ:PL\t"
    "0/1:5,5:99:121,0,428",
    "chr1\t200\t.\tC\tT\t30\tPASS\tAC=2\tGT:GQ:PL\t1/1:40:300,40,0",
]


def _write(path, rows, gz=False):
    text = HEADER + "".join(r + "\n" for r in rows)
    if gz:
        with gzip.open(path, "wt") as f:
            f.write(text)
    else:
        path.write_text(text)
    return path


def test_equal_vcfs(tmp_path, capsys):
    a = _write(tmp_path / "a.vcf", ROWS)
    b = _write(tmp_path / "b.vcf.gz", ROWS, gz=True)
    out = tmp_path / "out.jsonl"
    assert vcf_diff.main([str(a), str(b), "--site", "chr1:100",
                          "--out", str(out)]) == 0
    res = json.loads(capsys.readouterr().out)
    assert res["all_equal"] and res["equal_in_every_field"] == 2
    assert res["sites"]["chr1:100"]["equal"]
    assert json.loads(out.read_text()) == res


def test_one_pl_off_is_a_difference(tmp_path, capsys):
    """A PL one off at a near-tie, the GT the same: ``compare_vcf``'s key
    and GT agree, this does not."""
    a = _write(tmp_path / "a.vcf", ROWS)
    b = _write(tmp_path / "b.vcf", [ROWS[0].replace("428", "427"), ROWS[1],
                                    ROWS[1].replace("200", "300")])
    assert vcf_diff.main([str(a), str(b), "--site", "chr1:100"]) == 1
    res = json.loads(capsys.readouterr().out)
    assert (res["equal_in_every_field"], res["differ"], res["only_b"]) == (
        1, 1, 1)
    assert res["first_differing"][0]["b"].endswith("121,0,427")
    assert not res["sites"]["chr1:100"]["equal"]
    assert res["sites"]["chr1:100"]["a"][0].split("\t")[1] == "100"
