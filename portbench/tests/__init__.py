"""portbench.tests"""
