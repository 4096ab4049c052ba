from .manager import CheckpointManager, pack_sorted_int_array, unpack_sorted_int_array
