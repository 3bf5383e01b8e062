"""Kernels written by hand for Hopper, each beside its plain PyTorch twin.

Every wrapper counts its launches in ``LAUNCHES`` (a plain integer per
kernel name, bumped only where the kernel is launched) so a run can show
that its main path went through the kernel and not the plain version.
"""

LAUNCHES: dict[str, int] = {"paged_decode": 0, "dlzs_block": 0, "sufa": 0,
                            "flash": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
