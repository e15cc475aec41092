"""portbench.reference"""
