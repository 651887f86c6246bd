"""scenario"""
