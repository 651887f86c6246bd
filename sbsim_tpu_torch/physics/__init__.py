"""physics"""
