"""The port's YAML subset reader (``rofl_tpu_torch.fl.yaml_subset``) against
``yaml.safe_load``: every experiment file of ``configs/`` and edge strings
inside the subset give the same Python values (exact: ``repr`` equal, so
int / float / bool / None and NaN are told apart); strings outside the
subset raise ``YamlSubsetError`` rather than being guessed at."""

from pathlib import Path

import pytest
import yaml

from rofl_tpu_torch.fl.yaml_subset import YamlSubsetError, safe_load

CONFIGS = sorted((Path(__file__).resolve().parent.parent / "configs").glob("*.yml"))

INSIDE = [
    "a: 1",
    "a: -0x1F\nb: 0b101\nc: 012\nd: 1_000\ne: 09\nf: +7\ng: 0",
    "a: 1.5\nb: .5\nc: 5.\nd: 1e-3\ne: 1.0e-3\nf: 1.0e3\ng: -.inf\nh: .NaN\ni: 6.02e+23",
    "a: yes\nb: Off\nc: ~\nd:\ne: null\nf: TRUE\ng: n\nh: y",
    "a: 'it''s # not a comment'  # but this is\nb: \"x\\ty\\u00e9\\\\\"\nc: a#b\nd: it's",
    "---\na:\n  b:\n    c: 1\n  d: 2\ne: 3\n",
    "# only a comment\n\n",
    "",
    "a: b c d   # a comment after a value",
    "a:\n  # a comment inside a mapping\n  b: 1\n\n  c: 2",
    "key with spaces : v",
    "1: a\ntrue: b\n~: c",
    "a: -5\nb: +3\nc: '007'\nd: \"\"",
    "a: 1\na: 2",
    "enc_type: Plain   # Plain | Range | l2",
    "path: \"models/mnist_dev_initialized.txt\"\nname: mnist_plain_local",
]

OUTSIDE = [
    "a: [1, 2]", "a: {b: 1}", "a: &x 1", "a: *x", "a: !!str 1", "a: |\n  x", "a: >\n  x",
    "a:\n\tb: 1", "a: 1\n---\nb: 2", "- 1\n- 2", "a:\n  - 1", "'a': 1", "\"a\": 1",
    "a: 1:30", "a: 2001-12-14", "a: b: c", "a: 1\n  b: 2", "a: hello\n  world",
    "%YAML 1.1\n---\na: 1", "<<: 1", "a: \"x", "a: 'x' y", "a: 1\n...\n", "a:b",
    "a: 'multi\n  line'", "a: \"\\q\"", "? a\n: 1", "  a: 1\nb: 2",
]


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_every_experiment_file_reads_as_safe_load_reads_it(path):
    text = path.read_text()
    assert repr(safe_load(text)) == repr(yaml.safe_load(text))


@pytest.mark.parametrize("text", INSIDE)
def test_edge_strings_inside_the_subset(text):
    assert repr(safe_load(text)) == repr(yaml.safe_load(text))


@pytest.mark.parametrize("text", OUTSIDE)
def test_what_is_outside_the_subset_raises(text):
    with pytest.raises(YamlSubsetError):
        safe_load(text)
