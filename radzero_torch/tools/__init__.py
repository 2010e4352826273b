"""Tools of the port that run without the JAX package."""


def device_name(device) -> str:
    """The card's name, or "cpu": every tool's record names the device it ran on."""
    import torch

    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def launch_counts() -> dict:
    """Every counted kernel wrapper's ``.launches`` in this process, by wrapper name
    (the tools that run a leg in a process of its own report them)."""
    from radzero_torch.ops import counted_wrappers

    return {fn.__name__: fn.launches for fn in counted_wrappers()}
