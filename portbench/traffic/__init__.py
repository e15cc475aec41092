"""portbench.traffic"""
