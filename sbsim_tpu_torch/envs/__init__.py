"""envs"""
