"""portbench.systems"""
