"""NLP: Word2Vec (skip-gram and CBOW, negative sampling or hierarchical
softmax), ParagraphVectors (PV-DBOW, PV-DM), FastText, GloVe and the graph
vectors (DeepWalk, Node2Vec), trained on the device.

- ``text``               tokenizers, sentence iterators, LabelAwareIterator
- ``vocab``              VocabCache/VocabConstructor, Huffman, unigram table,
                         subsampling
- ``lookup_table``       InMemoryLookupTable (syn0/syn1/syn1neg, numpy
                         between fits)
- ``word2vec``           SequenceVectors engine and the Word2Vec builder
                         front: the device-windowed paths and the host pair
                         path (``device_corpus = False``)
- ``paragraph_vectors``  ParagraphVectors: PV-DBOW / PV-DM + infer_vector
- ``fasttext``           FastText: subword (character n-gram) vectors, OOV
                         queries
- ``glove``              Glove: co-occurrence counting + AdaGrad
- ``graph_vectors``      DeepWalk / Node2Vec over random walks
- ``serializer``         WordVectorSerializer: text, word2vec.c binary, the
                         model zip

The training rounds and the ``embedding_bag`` kernel that CBOW, PV-DM and
FastText launch live in ``ops/embeddings.py``. Sharded tables (``mesh=``)
train Word2Vec's negative-sampling skip-gram (``word2vec.py``); the other
paths refuse a mesh, as in the JAX package.
"""

from .fasttext import FastText, char_ngrams, fasttext_hash
from .glove import Glove
from .graph_vectors import DeepWalk, Graph, Node2Vec, random_walks
from .lookup_table import InMemoryLookupTable
from .paragraph_vectors import ParagraphVectors
from .serializer import (read_paragraph_vectors, read_word2vec_model,
                         read_word_vectors, write_paragraph_vectors,
                         write_word2vec_model, write_word_vectors)
from .text import (CollectionSentenceIterator, CommonPreprocessor,
                   DefaultTokenizerFactory, FileSentenceIterator,
                   LabelAwareIterator, LineSentenceIterator,
                   LowCasePreProcessor, NGramTokenizerFactory,
                   SentenceIterator, Tokenizer, TokenizerFactory,
                   TokenPreProcess)
from .vocab import (VocabCache, VocabConstructor, VocabWord, build_huffman,
                    huffman_arrays, subsample_keep_probs, unigram_int_table,
                    unigram_table)
from .word2vec import SequenceVectors, Word2Vec, WordVectors

__all__ = [
    "CollectionSentenceIterator", "CommonPreprocessor", "DeepWalk",
    "DefaultTokenizerFactory", "FastText", "FileSentenceIterator", "Glove",
    "Graph", "InMemoryLookupTable", "LabelAwareIterator",
    "LineSentenceIterator", "LowCasePreProcessor", "NGramTokenizerFactory",
    "Node2Vec", "ParagraphVectors", "SentenceIterator",
    "SequenceVectors", "TokenPreProcess", "Tokenizer", "TokenizerFactory",
    "VocabCache", "VocabConstructor", "VocabWord", "Word2Vec", "WordVectors",
    "build_huffman", "char_ngrams", "fasttext_hash", "huffman_arrays",
    "random_walks", "read_paragraph_vectors", "read_word2vec_model",
    "read_word_vectors", "subsample_keep_probs", "unigram_int_table",
    "unigram_table", "write_paragraph_vectors", "write_word2vec_model",
    "write_word_vectors",
]
