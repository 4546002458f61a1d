"""The least bytes of the kernels' calls, on hand-made inputs."""
import torch

import benchpath  # noqa: F401
from benchpath import one_torch_thread  # noqa: F401
import roofline

S = roofline.I32_SENTINEL


def test_band_bound_counts_the_sectors_in_band():
    # one row: b holds 64 ascending keys (8 sectors of 8 int32); a probes
    # key 100 with band 0, which lies in the second sector, and a sentinel
    b = torch.arange(0, 128, 2, dtype=torch.int32)[None]       # 64 keys
    a = torch.tensor([[100, S]], dtype=torch.int32)
    bands = torch.tensor([0], dtype=torch.int32)
    nbytes, ops = roofline.band_bound(torch, a, b, bands, 1)
    # b[50] == 100: the range [49, 52) touches sector 6 only
    assert nbytes == 1 * 2 * (4 + 1) + 4 * 1 + 32 * 1
    assert ops == 1 * 2 * (2 + 3 * 7)


def test_band_bound_widens_with_the_band_and_the_delta_plane():
    b = torch.arange(0, 128, 2, dtype=torch.int32)[None]
    a = torch.tensor([[100]], dtype=torch.int32)
    narrow = roofline.band_bound(torch, a, b, torch.tensor([0]), 4)[0]
    wide = roofline.band_bound(torch, a, b, torch.tensor([40]), 4)[0]
    assert wide > narrow
    with_delta = roofline.band_bound(torch, a, b, torch.tensor([40]), 4,
                                     delta_plane=True)[0]
    assert with_delta > wide
    walk = roofline.band_bound(torch, a, b, torch.tensor([40]), 4,
                               walk=True)[1]
    assert walk == roofline.band_bound(torch, a, b, torch.tensor([40]),
                                       4)[1] + 3 * 34  # keys 60..126: 34 in band


def test_unpack_bound_counts_rows_words_and_outputs():
    # two blocks: block 0 packs doc, pos, dist at widths 4, 8, 0 from lane
    # word 0; block 1 is constant (all widths 0)
    meta = torch.tensor([[0, 4 | (8 << 6), 0, 0, 0],
                         [16, 0, 5, 5, 5]], dtype=torch.int32)
    idx = torch.tensor([0, 1, 2, 128], dtype=torch.int32)
    nbytes, ops = roofline.unpack_bound(torch, meta, idx)
    # 4 ordinals read and 3 int32 outputs each; 2 metadata rows; lane
    # words: the doc field's word 0 (offsets 0-2 at 4 bits) and the pos
    # field's word 16 (its field starts 4 * 4 words on); none of block 1
    assert nbytes == 4 * 4 + 20 * 2 + 4 * 2 + 12 * 4
    assert ops == 40 * 4


def test_least_seconds_takes_the_larger_term():
    assert roofline.least_seconds(3.35e12, 0) == 1.0
    assert roofline.least_seconds(0, 33.5e12) == 1.0
    assert roofline.least_seconds(3.35e9, 33.5e12) == 1.0


def test_call_bound_reads_each_kernels_arguments():
    a = torch.tensor([[3, 9]], dtype=torch.int32)
    b = torch.tensor([[1, 3, 5, 9]], dtype=torch.int32)
    bd = torch.zeros_like(b)
    bands = torch.tensor([2], dtype=torch.int32)
    assert roofline.call_bound(torch, "intersect", (a, b, bands)) == \
        roofline.band_bound(torch, a, b, bands, 1)
    assert roofline.call_bound(torch, "min_delta", (a, b, bd, bands)) == \
        roofline.band_bound(torch, a, b, bands, 4, delta_plane=True,
                            walk=True)
    mask_bytes = roofline.call_bound(torch, "delta_mask",
                                     (a, b, bands, bands))[0]
    assert mask_bytes == roofline.band_bound(torch, a, b, bands, 8, walk=True,
                                             max_band=15)[0] + 4
