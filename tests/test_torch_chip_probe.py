"""The port's chip probe on the CPU: its SASS reader and its refusals.

The probe's rates and times need the card; what runs here is the
reading of ``cuobjdump -sass`` output, on listings written in its
format, and the argument handling.
"""

import pytest
import torch

from rustyhgi_tpu_torch.ops import cuda_codec
from rustyhgi_tpu_torch.tools import chip_probe


def _insn(addr: int, text: str) -> str:
    return f"        /*{addr:04x}*/                   {text} ;        /* 0x000000ffff037224 */\n"


def _function(name: str, body, branch) -> str:
    """A kernel: a prologue, a main loop of ``body`` closed by ``branch``,
    a one-round remainder loop, and the store."""
    text = f"\t\tFunction : {name}\n\t.headerflags\t@\"EF_CUDA_SM90\"\n"
    addr = 0
    for insn in ("LDC R1, c[0x0][0x28]", "S2R R2, SR_TID.X", "@!P0 BRA 0x0400"):
        text += _insn(addr, insn)
        addr += 16
    top = addr
    text += ".L_x_7:\n"
    for insn in body:
        text += _insn(addr, insn)
        addr += 16
    text += _insn(addr, branch(top))
    addr += 16
    rem = addr
    for insn in ("IADD3 R9, R7, 0x1, R5", "SHF.R.S32.HI R12, RZ, 0x1, R9",
                 "LOP3.LUT R7, R12, R7, RZ, 0x3c, !PT", "VIADD R5, R5, 0x1",
                 "ISETP.GE.AND P0, PT, R5, R4, PT", f"@!P0 BRA 0x{rem:x}"):
        text += _insn(addr, insn)
        addr += 16
    for insn in ("STG.E desc[UR6][R2.64], R7", "EXIT", "BRA {self}", "NOP"):
        text += _insn(addr, insn.format(self=hex(addr)))  # the trap: a branch to itself
        addr += 16
    return text


MIX3_BODY = (["IADD3 R9, R7, 0x1, R5", "SHF.R.S32.HI R12, RZ, 0x1, R9",
              "LOP3.LUT R12, R12, R7, RZ, 0x3c, !PT"] * 16
             + ["VIADD R11, R5, 0x8", "VIADD R5, R5, 0x4", "ISETP.GT.AND P0, PT, R11, R4, PT",
                "NOP", "NOP"])


@pytest.mark.parametrize(
    "branch",
    [lambda top: f"@!P0 BRA 0x{top:x}", lambda top: "@!P0 BRA `(.L_x_7)"],
    ids=["address", "label"],
)
def test_sass_loops_counts_the_main_loop_of_each_word_kernel(branch):
    mangled = ("_ZN45_GLOBAL__N__6450ca8f_12_hgi_probe_cu_09babe00"
               "13vpucal_kernelILi{}ELb{}EEEvPKhPhiiixi")
    sass = (_function("_ZN12_GLOBAL__N_111encode_levelILi0ELb1EEEvPKhPhS2_iiiix",
                      ["IADD3 R1, R1, 0x1, RZ"] * 99, branch)
            + _function(mangled.format(0, 0), ["FADD R1, R1, 1.5"] * 70, branch)
            + _function(mangled.format(0, 1), MIX3_BODY, branch)
            + _function(mangled.format(4, 1), ["FADD R1, R1, 1.5"] * 32 + ["FMUL R1, R1, 0.5"] * 16
                        + ["UIADD3 UR4, UR4, 0x4, URZ", "ISETP.LT.AND P0, PT, R5, R4, PT"], branch))
    loops = chip_probe.sass_loops(sass)
    assert set(loops) == {"mix3", "f32add"}
    mix3 = loops["mix3"]
    # 48 chain instructions + 3 of loop control + the branch; the NOPs are not counted.
    assert mix3["loop_instructions"] == 52
    assert mix3["per_thread_round"] == 52 / chip_probe.UNROLL
    assert mix3["per_pixel_round"] == 52 / (4 * chip_probe.UNROLL)
    assert mix3["remainder_loop_instructions"] == 6
    assert mix3["opcodes"]["IADD3"] == 16 and mix3["opcodes"]["BRA"] == 1
    assert "NOP" not in mix3["opcodes"]
    assert "ILi0ELb1E" in mix3["function"]
    assert loops["f32add"]["opcodes"] == {"FADD": 32, "FMUL": 16, "UIADD3": 1,
                                          "ISETP.LT.AND": 1, "BRA": 1}


def test_sass_loops_of_a_listing_without_the_kernels_is_empty():
    assert chip_probe.sass_loops("") == {}
    assert chip_probe.sass_loops(_function("_Z3fooPi", ["IADD3 R1, R1, 0x1, RZ"],
                                           lambda top: f"BRA 0x{top:x}")) == {}


def test_vpucal_rejects_unknown_rows(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="unknown vpucal rows"):
        chip_probe.cmd_vpucal(["mix3x16", "xla"])


def test_rows_are_the_jax_probes_with_torch_for_xla():
    assert chip_probe.ROWS == ("mix3x16", "add", "shift", "csel", "f32add", "torch")
    assert (chip_probe.K_LO, chip_probe.K_HI, chip_probe.SHAPE) == (200, 2000, (8, 1080, 1920))


LANES_BODY = [  # two rows of X1's lanes loop, as nvcc emits them
    "LDS.U8 R4, [R12+UR5]", "LEA R4, R4, UR9, 0x4", "LDS.128 R4, [R4]",
    "STS.U16 [R72], R77", "ISETP.GE.U32.AND P0, PT, R77, R66, PT",
    "@P0 SHF.R.U32.HI R77, RZ, 0x10, R77", "IMAD.HI.U32 R66, R77, R64, RZ",
    "LEA.HI R64, R67, R77, RZ, 0x10", "IMAD.MOV.U32 R67, RZ, RZ, RZ",
    "IMAD.HI.U32 R66, R77, R65, R66", "IMAD R77, R66, R73, R64",
    "ISETP.GE.U32.AND P0, PT, R77, R50, PT", "@P0 SHF.R.U32.HI R77, RZ, 0x10, R77",
    "IMAD.HI.U32 R50, R77, R48, RZ", "IMAD.HI.U32 R50, R77, R49, R50",
    "IMAD R77, R50, R65, R64", "ISETP.GT.AND P1, PT, R70, 0x6, PT",
]


@pytest.mark.parametrize(
    "branch",
    [lambda top: f"@P1 BRA 0x{top:x}", lambda top: "@P1 BRA `(.L_x_7)"],
    ids=["address", "label"],
)
def test_sass_chain_follows_the_state_through_the_lanes_loop(branch):
    sass = (_function("_ZN12_GLOBAL__N_111encode_levelILi0EEEvPKh",
                      ["IMAD.HI.U32 R1, R1, R2, RZ"] * 40, branch)
            + _function("_ZN12_GLOBAL__N_117rans_encode_lanesILi32ELb1EEEvPKh", LANES_BODY,
                        branch))
    got = chip_probe.sass_chain(sass, "rans_encode_lanesILi32ELb1E", 2, "IMAD.HI.U32")
    assert got["loop_instructions"] == len(LANES_BODY) + 1  # the branch included
    # ISETP, SHF, IMAD.HI, IMAD.HI, IMAD a row: the entry loads and the
    # stored word stay off the state's chain.
    assert got["chain_opcodes"] == ["ISETP.GE.U32.AND", "SHF.R.U32.HI", "IMAD.HI.U32",
                                    "IMAD.HI.U32", "IMAD"] * 2
    assert got["chain"] == 10 and got["chain_per_row"] == 5.0
    assert chip_probe.sass_chain(sass, "no_such_kernel", 2, "IMAD.HI.U32") is None


def test_dataflow_reads_guards_pairs_and_carries():
    assert chip_probe._dataflow("@!P0 IMAD.WIDE.U32 R6, R2, R9, R6") == (
        "IMAD.WIDE.U32", ["R6", "R7"], ["P0", "R6", "R7", "R2", "R9", "R6", "R7"])
    assert chip_probe._dataflow("ISETP.GE.U32.AND P0, PT, R5, R7, PT") == (
        "ISETP.GE.U32.AND", ["P0"], ["R5", "R7"])
    assert chip_probe._dataflow("STG.E.U16 desc[UR6][R4.64], R2") == (
        "STG.E.U16", [], ["UR6", "R4", "R5", "R2"])
    assert chip_probe._dataflow("LDS.128 R8, [R3+UR4]")[1] == ["R8", "R9", "R10", "R11"]
    assert chip_probe._dataflow("IADD3 R4, P1, R2, R3, RZ")[1:] == (["R4", "P1"], ["R2", "R3"])


def test_ptxas_summary_reads_the_named_kernels():
    log = (
        "ptxas info    : Compiling entry function '_Z13encode_tilesILi0ELb1EEv' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z13encode_tilesILi0ELb1EEv\n"
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 40 registers, used 1 barriers, 2048 bytes smem, 640 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_Z3fooPi' for 'sm_90a'\n"
        "ptxas info    : Used 12 registers, used 0 barriers\n"
    )
    assert chip_probe.ptxas_summary(log, ["encode_tiles"]) == {
        "_Z13encode_tilesILi0ELb1EEv": {"spill_stores": 8, "spill_loads": 4,
                                        "registers": 40, "smem": 2048}}


def test_sweep_choices_fit_the_kernels():
    for th, tw in chip_probe.SWEEP_TILES:
        assert th % 16 == 0 and tw % 16 == 0
    assert set(chip_probe.SWEEP_LANE_BLOCKS) == {32, 64, 128}
    assert max(chip_probe.SWEEP_FINE) <= 5


def test_sweep_decode_choices_fit_the_kernels():
    assert 0 in chip_probe.SWEEP_DECODE_FINE  # one launch a level
    assert all(0 <= f <= 5 for f in chip_probe.SWEEP_DECODE_FINE)
    fine = cuda_codec.DECODE_FINE_LEVELS
    for th, tw in chip_probe.SWEEP_DECODE_TILES:
        assert th % 16 == 0 and tw % 16 == 0 and (th | tw) % (1 << fine) == 0


def test_sweep_times_every_decode_tile_and_a_preview():
    assert set(cuda_codec.DECODE_TILES) <= set(chip_probe.SWEEP_DECODE_TILES)
    assert all(0 < upto < chip_probe.SWEEP_LEVELS[0] for upto in chip_probe.SWEEP_PREVIEWS)
    assert 2 in chip_probe.SWEEP_PREVIEWS  # the CLI's and the smoke's preview


def test_sweep_compares_whole_subband_layouts():
    """The sweep's check of a K3 tiling: anchors, every quad and the recon."""
    from rustyhgi_tpu_torch.ops import pyramid
    from rustyhgi_tpu_torch.ops.quantizers import QuantizationLevel, quantize_fn

    img = torch.arange(2 * 40 * 56, dtype=torch.int64).reshape(2, 40, 56).mul(37).remainder(251)
    img = img.to(torch.uint8)
    table = quantize_fn(QuantizationLevel.MEDIUM).table
    want = pyramid.encode_subbands(img, 3, table)
    got = pyramid.encode_subbands(img.clone(), 3, table)
    assert chip_probe._same_layout(got, want)
    got[1][2][1][1, 0, 0] ^= 1
    assert not chip_probe._same_layout(got, want)


def _jax_validate_cases():
    """The case list of the JAX probe's ``cmd_validate``, read from its
    source (importing it would start JAX on its compilation cache)."""
    import ast
    import os

    path = os.path.join(os.path.dirname(__file__), os.pardir, "tools", "chip_probe.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "cmd_validate")
    loop = next(n for n in ast.walk(fn) if isinstance(n, ast.For) and isinstance(n.iter, ast.List))

    def value(node):
        if isinstance(node, ast.Attribute):  # QuantizationLevel.X
            return node.attr
        if isinstance(node, ast.Tuple):
            return tuple(value(e) for e in node.elts)
        return ast.literal_eval(node)

    return [value(e) for e in loop.iter.elts]


def test_validate_cases_are_the_jax_probes():
    ours = [(shape, levels, preset.name, pred)
            for shape, levels, preset, pred in chip_probe.VALIDATE_CASES]
    assert ours == _jax_validate_cases()
    assert len(ours) == 5


@pytest.mark.parametrize("argv", [["vpucal"], ["sweep"], ["validate"], ["times"], None])
def test_subcommand_without_a_card_raises(monkeypatch, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        if argv is None:
            chip_probe.validate(chip_probe.VALIDATE_CASES[2:])
        else:
            chip_probe.main(argv)
