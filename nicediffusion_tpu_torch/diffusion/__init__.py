"""Diffusion process: schedule tables, CFG and the DDPM/DDIM sampling chain."""
