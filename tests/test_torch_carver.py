"""The port's carver (tilelang_mesh_tpu_torch/carver) against the JAX
package's (tilelang_mesh_tpu/carver): a GEMM or attention tiling's
roofline arithmetic (FLOPs, HBM bytes, step count) and the tile-size
ladder are the JAX package's, the ranking breaks ties the same way, every
block the H100 template proposes at bench.py's GEMM shapes is an instance
of the yardstick kernel, and every attention tile it proposes is an
instance of the forward kernel that fits the card. Exact comparisons: the
quantities are integers or the same float expressions."""

import pytest
import torch

from tilelang_mesh_tpu import carver as ref
from tilelang_mesh_tpu.carver import roller as ref_roller
from tilelang_mesh_tpu_torch import carver as port
from tilelang_mesh_tpu_torch.carver import arch as port_arch
from tilelang_mesh_tpu_torch.carver import roller as port_roller

# bench.py's GEMM shapes: gemm_quickstart, gemm_large (full and quick),
# fp8_gemm and w4a16_gemm (full and quick)
HEADLINE = [(1024, 1024, 1024, "bfloat16"), (8192, 8192, 4096, "bfloat16"),
            (2048, 2048, 2048, "bfloat16"),
            (4096, 4096, 4096, "float8_e4m3fn"),
            (1024, 1024, 1024, "float8_e4m3fn"),
            (4096, 4096, 4096, "bfloat16")]


@pytest.mark.parametrize("M,N,K,dtype", [
    (1024, 1024, 1024, "bfloat16"), (8192, 8192, 4096, "bfloat16"),
    (4096, 4096, 4096, "float8_e4m3fn"), (512, 1024, 2048, "float32")])
def test_candidate_arithmetic_matches_jax(M, N, K, dtype):
    """For every tiling the JAX template enumerates, the port's
    Candidate of the same (bm, bn, bk) has the same FLOPs, HBM bytes
    and step count."""
    jax_cands = ref.MatmulTemplate(M, N, K, dtype,
                                   arch=ref.TPU_V5E).candidates()
    assert jax_cands
    t = port.MatmulTemplate(M, N, K, dtype, arch=port.H100_SXM)
    for jc in jax_cands:
        cfg = jc.config
        pc = t.candidate(cfg["block_M"], cfg["block_N"], cfg["block_K"])
        assert pc.config == cfg
        assert (pc.flops, pc.hbm_bytes, pc.n_tiles) == (
            jc.flops, jc.hbm_bytes, jc.n_tiles)


@pytest.mark.parametrize("dim", [1, 7, 64, 96, 128, 1000, 1024, 4096, 6144,
                                 8192])
@pytest.mark.parametrize("minimum,cap", [(128, 1024), (32, 64), (128, 256),
                                         (16, 2048)])
def test_tile_candidates_match_jax(dim, minimum, cap):
    assert port_roller._tile_candidates(dim, minimum, cap) == \
        ref_roller._tile_candidates(dim, minimum, cap)


def test_rank_breaks_ties_as_jax():
    """Candidates of equal predicted time come out in the JAX package's
    order: squarer tiles first, then the larger last block dimension."""
    blocks = [(128, 256, 32), (256, 256, 64), (128, 128, 64),
              (256, 128, 64), (128, 128, 32), (256, 256, 32)]

    def cfg(b):
        return {"block_M": b[0], "block_N": b[1], "block_K": b[2]}
    jax_order = [h.config for h in ref.DefaultPolicy(ref.TPU_V5E).rank(
        [ref.Candidate(cfg(b), 1e9, 1e6) for b in blocks])]
    port_order = [h.config for h in port.DefaultPolicy(port.H100_SXM).rank(
        [port.Candidate(cfg(b), 1e9, 1e6) for b in blocks])]
    assert port_order == jax_order


@pytest.mark.parametrize("M,N,K,dtype", HEADLINE)
def test_headline_hints_are_kernel_instances(M, N, K, dtype):
    t = port.MatmulTemplate(M, N, K, dtype, arch=port.H100_SXM)
    hints = t.hints(10)
    assert hints
    for h in hints:
        c = h.config
        assert (c["block_M"], c["block_N"], c["block_K"]) in \
            port.KERNEL_BLOCKS
    assert port.recommend_hints(t, 3) == t.hints(3)


def test_kernel_blocks_fit_the_card_in_every_type():
    """Every type proposes the same six blocks: operand tiles double
    buffered within 227 KB, the f32 accumulator within half the SM's
    registers; 256 x 256 is refused by the register budget."""
    assert port.KERNEL_BLOCKS == {(128, 128, 32), (128, 128, 64),
                                  (128, 256, 32), (128, 256, 64),
                                  (256, 128, 32), (256, 128, 64)}
    for dt in ("float32", "bfloat16", "float16", "float8_e4m3fn"):
        assert port.proposable_blocks(port.H100_SXM, dt) == \
            port.KERNEL_BLOCKS
    c = port.MatmulTemplate(1024, 1024, 1024, arch=port.H100_SXM).candidate(
        256, 256, 64)
    assert not port.DefaultPolicy(port.H100_SXM).fits(c)


def test_h100_model():
    a = port.H100_SXM
    assert a.min_tile("bfloat16") == (16, 8, 16)
    assert a.min_tile("float8_e4m3fn") == (16, 8, 32)
    assert a.peak_class("float8_e4m3fn") == "i8"
    assert a.peak_class("float32") == "f32"
    assert a.acc_budget_bytes() == 128 * 1024
    with pytest.raises(TypeError):
        port.dtype_bytes("float64")


def test_auto_arch_raises_without_a_known_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.auto_arch()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA A100-SXM4-80GB")
    with pytest.raises(RuntimeError, match="no model"):
        port.auto_arch()
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    assert port_arch.auto_arch() is port.H100_SXM


# bench.py's flash configs (cfg_flash: B 2, H 16, S 2048; 512 quick) and
# ragged and rectangular shapes
FLASH = [(2048, 2048, 64, True), (2048, 2048, 128, True),
         (2048, 2048, 128, False), (512, 512, 128, True),
         (1024, 4096, 64, False), (4096, 1024, 128, True)]


@pytest.mark.parametrize("Sq,Sk,D,causal", FLASH)
def test_flash_candidate_arithmetic_matches_jax(Sq, Sk, D, causal):
    """For every tiling the JAX FlashAttentionTemplate enumerates, the
    port's Candidate of the same (bm, bn) has the same FLOPs, HBM bytes
    and step count."""
    jax_cands = ref.FlashAttentionTemplate(
        Sq, Sk, D, batch_heads=32, causal=causal,
        arch=ref.TPU_V5E).candidates()
    assert jax_cands
    t = port.FlashAttentionTemplate(Sq, Sk, D, batch_heads=32,
                                    causal=causal, arch=port.H100_SXM)
    for jc in jax_cands:
        cfg = jc.config
        pc = t.candidate(cfg["block_M"], cfg["block_N"])
        assert pc.config == cfg
        assert (pc.flops, pc.hbm_bytes, pc.n_tiles) == (
            jc.flops, jc.hbm_bytes, jc.n_tiles)


@pytest.mark.parametrize("Sq,Sk,D,causal", FLASH + [
    (77, 77, 16, True), (1000, 1000, 32, False)])
def test_flash_hints_are_kernel_instances_that_fit(Sq, Sk, D, causal):
    """The template proposes every instance of the kernel at the head_dim
    (its candidate space), each within a block's shared memory and
    register budget on the H100; an unbuilt head_dim raises."""
    t = port.FlashAttentionTemplate(Sq, Sk, D, batch_heads=32,
                                    causal=causal, arch=port.H100_SXM)
    tiles = port.FLASH_KERNEL_TILES[D]
    hints = t.hints(8)
    assert sorted((h.config["block_M"], h.config["block_N"])
                  for h in hints) == sorted(tiles)
    policy = port.DefaultPolicy(port.H100_SXM)
    for bm, bn in tiles:
        c = t.candidate(bm, bn)
        assert policy.fits(c)
        # the Q tile and two stages of K and V, rows padded by 8
        assert c.smem_bytes == (bm + 4 * bn) * (D + 8) * 2
        assert c.smem_bytes <= port.H100_SXM.smem_per_block
    assert port.recommend_hints(t, 2) == hints[:2]
    with pytest.raises(ValueError, match="head_dim=48"):
        port.FlashAttentionTemplate(Sq, Sk, 48, arch=port.H100_SXM).hints()
