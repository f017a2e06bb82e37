"""The zoo's ``pretrained=True``: the weights need a download, which the
port does not do (as the JAX package does not)."""


def no_pretrained(pretrained: bool) -> None:
    """Raise ``NotImplementedError`` when ``pretrained`` is asked for."""
    if pretrained:
        raise NotImplementedError(
            "pretrained weights need a download; load a local checkpoint "
            "with set_state_dict instead")
