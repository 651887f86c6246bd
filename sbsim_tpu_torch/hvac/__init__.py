"""hvac"""
