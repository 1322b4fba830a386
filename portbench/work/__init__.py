"""Frozen counts of the work a cell asks for, from its shapes alone: the
card's peaks, the CTC pair's bytes, the int8 GEMM's bound, and model FLOPs
counted on the reference. They stay the same whatever implements the work.
"""
