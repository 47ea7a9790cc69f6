"""The published Wan2.1 key names of the port's VAE and umT5 modules (the
inverse of `videocof_torch.models.weights`' maps, written out
independently), to fill published-layout state dicts in the tests."""


def vae_published_name(name, cfg):
    """The port's VAE key -> the published ``Wan2.1_VAE.pth`` key."""
    res = {"norm1.gamma": "residual.0.gamma", "conv1": "residual.2",
           "norm2.gamma": "residual.3.gamma", "conv2": "residual.6",
           "shortcut": "shortcut"}
    attn = {"norm.gamma": "norm.gamma", "qkv": "to_qkv", "proj": "proj"}
    top = {"quant_conv": "conv1", "post_quant_conv": "conv2"}
    parts = name.split(".")
    if parts[0] in top:
        return ".".join([top[parts[0]]] + parts[1:])
    part, mod, rest = parts[0], parts[1], parts[2:]
    nrb = cfg.num_res_blocks
    if mod in ("conv1",):
        return name
    if mod in ("mid_rb1", "mid_rb2", "mid_attn"):
        idx = {"mid_rb1": 0, "mid_attn": 1, "mid_rb2": 2}[mod]
        table = attn if mod == "mid_attn" else res
        leaf = ".".join(rest)
        for k, v in table.items():
            if leaf.startswith(k):
                return f"{part}.middle.{idx}.{v}{leaf[len(k):]}"
    if mod == "head_norm":
        return f"{part}.head.0.gamma"
    if mod == "head_conv":
        return f"{part}.head.2.{rest[-1]}"
    # down.<i>.res.<j>.* / down.<i>.resample.{conv,time_conv}.*
    stage = int(rest[0])
    per = nrb + 1 if part == "encoder" else nrb + 2
    seq_name = "downsamples" if part == "encoder" else "upsamples"
    if rest[1] == "res":
        seq = stage * per + int(rest[2])
        leaf = ".".join(rest[3:])
        for k, v in res.items():
            if leaf.startswith(k):
                return f"{part}.{seq_name}.{seq}.{v}{leaf[len(k):]}"
    seq = stage * per + per - 1
    sub = "resample.1" if rest[2] == "conv" else "time_conv"
    return f"{part}.{seq_name}.{seq}.{sub}.{rest[3]}"


def t5_published_name(name):
    if name == "token_embedding":
        return "token_embedding.weight"
    return (name.replace("pos_emb", "pos_embedding.embedding.weight")
            .replace("ffn.gate.weight", "ffn.gate.0.weight"))


def vae22_published_name(name, cfg):
    """The port's Wan2.2 VAE key -> the published ``Wan2.2_VAE.pth`` key
    (each stage a residual block holding its own Sequential)."""
    res = {"norm1.gamma": "residual.0.gamma", "conv1": "residual.2",
           "norm2.gamma": "residual.3.gamma", "conv2": "residual.6",
           "shortcut": "shortcut"}
    parts = name.split(".")
    if parts[0] in ("quant_conv", "post_quant_conv") or parts[1] in (
            "conv1", "mid_rb1", "mid_rb2", "mid_attn", "head_norm",
            "head_conv"):
        return vae_published_name(name, cfg)
    part, stage, rest = parts[0], int(parts[2]), parts[3:]
    seq = "downsamples" if part == "encoder" else "upsamples"
    per = cfg.num_res_blocks + (0 if part == "encoder" else 1)
    pre = f"{part}.{seq}.{stage}.{seq}"
    if rest[0] == "res":
        leaf = ".".join(rest[2:])
        for k, v in res.items():
            if leaf.startswith(k):
                return f"{pre}.{rest[1]}.{v}{leaf[len(k):]}"
    sub = "resample.1" if rest[1] == "conv" else "time_conv"
    return f"{pre}.{per}.{sub}.{rest[2]}"
