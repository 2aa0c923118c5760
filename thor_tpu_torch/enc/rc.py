"""Leaky-bucket per-SB rate control (mirrors enc/rc.c)."""
from __future__ import annotations

MAX_STEP_SIZE = 228
INTRA_FIXED_QP = 32

QP2STEP = [0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 4, 4, 5, 5, 6, 7,
           8, 9, 10, 11, 12, 14, 16, 18, 20, 22, 25, 28, 32, 36, 40, 45, 51,
           57, 64, 72, 80, 90, 102, 114, 128, 144, 160, 180, 204, 228]

STEP2QP = [
    0, 4, 10, 14, 16, 18, 20, 21, 22, 23, 24, 25, 26, 26, 27, 27, 28, 29,
    29, 29, 30, 30, 31, 31, 32, 32, 32, 33, 33, 33, 33, 34, 34, 34, 35, 35,
    35, 35, 35, 36, 36, 36, 36, 37, 37, 37, 37, 37, 38, 38, 38, 38, 38, 38,
    39, 39, 39, 39, 39, 39, 39, 40, 40, 40, 40, 40, 40, 40, 41, 41, 41, 41,
    41, 41, 41, 41, 41, 42, 42, 42, 42, 42, 42, 42, 42, 42, 43, 43, 43, 43,
    43, 43, 43, 43, 43, 43, 44, 44, 44, 44, 44, 44, 44, 44, 44, 44, 44, 44,
    45, 45, 45, 45, 45, 45, 45, 45, 45, 45, 45, 45, 45, 46, 46, 46, 46, 46,
    46, 46, 46, 46, 46, 46, 46, 46, 46, 46, 47, 47, 47, 47, 47, 47, 47, 47,
    47, 47, 47, 47, 47, 47, 47, 47, 47, 48, 48, 48, 48, 48, 48, 48, 48, 48,
    48, 48, 48, 48, 48, 48, 48, 48, 48, 49, 49, 49, 49, 49, 49, 49, 49, 49,
    49, 49, 49, 49, 49, 49, 49, 49, 49, 49, 49, 49, 50, 50, 50, 50, 50, 50,
    50, 50, 50, 50, 50, 50, 50, 50, 50, 50, 50, 50, 50, 50, 50, 50, 50, 50,
    51, 51, 51, 51, 51, 51, 51, 51, 51, 51, 51, 51, 51]


class RateControl:
    def __init__(self, target_bits: int, num_sb: int):
        self.num_sb = num_sb
        self.target_bits = target_bits
        self.buffer_level = target_bits
        self.buffer_level_init = target_bits
        bits_per_sb = target_bits // max(1, num_sb)
        step = min(MAX_STEP_SIZE, 2048 // max(1, bits_per_sb))
        qp = max(INTRA_FIXED_QP, STEP2QP[step])
        self.bits_step_size_sliding_window = target_bits * QP2STEP[qp]
        self.over_prod_bits = 0
        self.corr_factor = 1 << 8
        self.sb_bits = [bits_per_sb] * num_sb
        self.sb_qp = [qp] * num_sb
        self.bits_step_size_current_frame = 0
        self.max_qp = 51
        self.min_qp = 1

    def init_frame(self, min_qp: int, max_qp: int):
        self.bits_step_size_current_frame = 0
        self.max_qp = max_qp
        self.min_qp = min_qp

    def update_frame(self, num_bits_frame: int):
        self.buffer_level += num_bits_frame - self.target_bits
        if self.buffer_level < 0:
            self.buffer_level = 0
        self.over_prod_bits = (self.buffer_level -
                               self.buffer_level_init) << 8
        if num_bits_frame > 0:
            self.corr_factor = ((self.target_bits << 8) +
                                (num_bits_frame >> 1)) // num_bits_frame
        self.bits_step_size_sliding_window = \
            self.bits_step_size_current_frame
        self.bits_step_size_current_frame = 0

    def update_sb(self, sb_idx: int, current_bits: int, current_qp: int):
        last_bits = self.sb_bits[sb_idx]
        last_qp = self.sb_qp[sb_idx]
        cur_step = QP2STEP[current_qp]
        last_step = QP2STEP[last_qp]
        self.sb_bits[sb_idx] = current_bits
        self.sb_qp[sb_idx] = current_qp
        self.bits_step_size_sliding_window += (current_bits * cur_step -
                                               last_bits * last_step)
        self.bits_step_size_current_frame += current_bits * cur_step
        target = self.target_bits - ((self.over_prod_bits + 128) >> 8)
        if target <= 0:
            target = 1
        new_step = ((self.bits_step_size_sliding_window + (target >> 1)) //
                    target)
        new_step = min(MAX_STEP_SIZE, max(1, new_step))
        new_qp = STEP2QP[new_step]
        new_qp = min(self.max_qp, max(self.min_qp, new_qp))
        self.over_prod_bits += ((current_bits << 8) -
                                self.corr_factor * last_bits)
        return new_qp
