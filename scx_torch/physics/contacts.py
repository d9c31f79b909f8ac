"""Contact constants shared with scx.physics.contacts.

The CUDA side has the same two numbers in csrc/planar_device.cuh (K,
NCAND); `scx_torch.physics.planar.check_kernel_layout` compares them.
"""

MAX_CONTACTS_PER_PAIR = 4
# contact candidates the narrowphase generates per pair (4 + 4 face, 2 edge)
N_CANDIDATES = 10
