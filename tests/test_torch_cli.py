"""The port's CLI prints the same answer line as gnnpe_tpu's CLI."""

import pytest

from gnnpe_tpu.frontends import cli as ref_cli
from gnnpe_tpu.io.datasets import powerlaw_graph, sample_query
from gnnpe_tpu_torch.frontends import cli


def _answer(capsys, main, argv):
    assert main(argv) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    return last.split(" Query Time")[0]


@pytest.mark.parametrize("variant", ["pe", "pge"])
def test_cli_answer_line_matches_reference(tmp_path, capsys, variant):
    g = powerlaw_graph(400, 1400, 8, seed=3, max_degree=40)
    g.to_graph_file(str(tmp_path / "data.graph"))
    sample_query(g, 5, seed=1).to_graph_file(str(tmp_path / "query.graph"))
    common = ["--file", str(tmp_path), "--data", "data.graph",
              "--query", "query.graph", "--variant", variant,
              "--mode", "online", "-l", "2", "-e", "2"]
    want = _answer(capsys, ref_cli.main,
                   common + ["--workdir", str(tmp_path / "ref")])
    got = _answer(capsys, cli.main,
                  common + ["--workdir", str(tmp_path / "port"),
                            "--device", "cpu"])
    label = "Answer Number: " if variant == "pe" else "Answer Num: "
    assert want.startswith(label) and int(want[len(label):]) > 0
    assert got == want
    # A second run serves from the cached artifacts.
    assert _answer(capsys, cli.main,
                   common + ["--workdir", str(tmp_path / "port"),
                             "--device", "cpu"]) == want


def test_cli_requires_dataset_dir():
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--mode", "online"])
