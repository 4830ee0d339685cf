"""Elastic rescale in the port, the twin of ``tests/test_elastic.py``'s
second test (see ``test_torch_elastic.py``): a shrink that halves a
4-rank mesh, and a restore onto the same rank count with a changed
partition, both within the reference's parity bounds.
"""

from _torch_dist import assert_parity, elastic_runner


def test_checkpoint_rescale_shrink_and_repartition(tmp_path):
    """A shrink that halves a 4-rank mesh (4 -> 2), and a restore onto the
    same rank count with a changed partition (2x2 -> 4x1 pure data
    parallel): both keep the fixed batch's loss."""
    run = elastic_runner(str(tmp_path / "ck"))
    saved = run(4, "2x2", "save")
    shrunk = run(2, "1x2", "restore")    # 4 -> 2 ranks
    assert_parity(saved, shrunk, "4 -> 2 ranks")
    repart = run(4, "4x1", "restore")    # same ranks, new partitioning
    assert_parity(saved, repart, "2x2 -> 4x1 repartition")
