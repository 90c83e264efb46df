"""Which of a trace's kernels are attention's, by the names the program's
CUDA sources give them."""

FORWARD = ("attn_fwd_wgmma_kernel", "attn_tile_kernel", "attn_split_kernel",
           "attn_combine_kernel", "flash_attention_kernel")
BACKWARD = ("attn_bwd_",)
BACKWARD_CALL = "attn_bwd_prep_kernel"  # one launch per backward call


def matches(name: str, prefixes) -> bool:
    return any(p in name for p in prefixes)


def attention_call(run) -> tuple[int, int, int, int, int, int]:
    """(b, s, h, hkv, hd, hd_v) of every attention call of the cell's step:
    a microbatch's rows at the traffic's sequence length."""
    att = run.model.attention()
    rows = run.traffic["batch"] // run.traffic["microbatches"]
    return (rows, run.traffic["seq"], att["heads"], att["kv_heads"], att["qk_dim"],
            att["v_dim"])
